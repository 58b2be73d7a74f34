"""Tiny stand-ins of the cells for the CPU tests: the same files'
structure at widths a test run can hold."""
from __future__ import annotations

import copy
import json

from hero_bench import models, registry

CELL = "qwen3-1.7b-train-4x4096"

TINY_DENSE = {"num_hidden_layers": 2, "hidden_size": 64,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 16, "intermediate_size": 128, "vocab_size": 512,
              "tie_word_embeddings": True, "rope_theta": 1000000,
              "rms_norm_eps": 1e-06}


def train_cell(name: str = CELL):
    wl = copy.deepcopy(registry.load_workload(name))
    conf = copy.deepcopy(registry.load_config(wl["config"]))
    conf.update(TINY_DENSE)
    conf["dtype"] = "float32"
    wl["mix"].update(batch=2, seq=16)
    return wl, conf


def bench() -> dict:
    return json.loads((registry.REPO / "BENCHMARK.json").read_text())


def program_model(conf: dict, seed: int):
    """The program's parameters and the benchmark's weights for ``conf``
    on the CPU, built through the configuration's family."""
    import torch
    family = registry.load_family(conf["family"])
    return models.program_model(
        family.model_config(conf), seed, torch.device("cpu"),
        lambda leaf, shape: family.init_scale(leaf, shape, conf))
