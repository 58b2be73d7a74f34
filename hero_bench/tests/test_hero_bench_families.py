"""A model family is found by the configuration file's ``family`` key:
``families/<family>.py`` builds the program's model configuration, scales
the weights and counts a train step's FLOPs, ``reference/<family>.py``
is its plain reference.  The dense family through the lookup gives what
the harness gave before the lookup existed, and a family planted as new
files in another benchmark directory runs a cell end to end."""
import json
import shutil
import time

import pytest
import torch

from hero_bench import registry
from hero_bench.report import measure
from hero_bench.tests import tiny

SEED = 3_000_000_017

# tiny.train_cell() at SEED, read from the harness before the family
# lookup (its dense-only code): each leaf's first and last weight, the
# step's model FLOPs at 2 x 16 tokens, and the comparison's numbers
PINNED_LEAVES = {
    "embed": (-0.1443193405866623, 0.13555210828781128),
    "final_norm.scale": (1.0, 1.0),
    "blocks.0.ln1.scale": (1.0, 1.0),
    "blocks.0.attn.wk": (0.15990962088108063, -0.07306177169084549),
    "blocks.0.attn.wo": (0.08957285434007645, 0.21985386312007904),
    "blocks.0.attn.wq": (-0.05117785558104515, -0.04678892344236374),
    "blocks.0.attn.wv": (-0.17545101046562195, -0.21930831670761108),
    "blocks.0.ln2.scale": (1.0, 1.0),
    "blocks.0.mlp.w_down": (0.09984850883483887, 0.06040547788143158),
    "blocks.0.mlp.w_gate": (-0.11312498897314072, -0.018194610252976418),
    "blocks.0.mlp.w_up": (-0.22250264883041382, -0.0736275464296341),
    "blocks.1.ln1.scale": (1.0, 1.0),
    "blocks.1.attn.wk": (-0.0510505847632885, -0.008530179038643837),
    "blocks.1.attn.wo": (-0.25, -0.05443556606769562),
    "blocks.1.attn.wq": (-0.0027166856452822685, -0.021346883848309517),
    "blocks.1.attn.wv": (0.018084852024912834, -0.030111337080597878),
    "blocks.1.ln2.scale": (1.0, 1.0),
    "blocks.1.mlp.w_down": (-0.1767766922712326, -0.04320213571190834),
    "blocks.1.mlp.w_gate": (0.044968754053115845, -0.1342238187789917),
    "blocks.1.mlp.w_up": (-0.04504743590950966, 0.15060628950595856),
}
PINNED_FLOPS = 20865024.0
PINNED_CHECKS = {
    "loss_gap": 7.656967254443549e-08,
    "first_grad_gap": 9.386951795591144e-07,
    "first_grad_err": 6.966941692717395e-07,
    "first_grad_err_median": 4.628774358960137e-07,
    "change_gap": 1.3082646567069931e-06,
}


def test_dense_weights_are_the_ones_drawn_before():
    _, conf = tiny.train_cell()
    _, w = tiny.program_model(conf, SEED)
    got = {k: (float(t.reshape(-1)[0]), float(t.reshape(-1)[-1]))
           for k, t in w.tensors.items()}
    assert got == PINNED_LEAVES


def test_dense_step_flops_are_the_ones_counted_before():
    wl, conf = tiny.train_cell()
    family = registry.load_family(conf["family"])
    assert family.train_step_flops(conf, wl["mix"]["batch"],
                                   wl["mix"]["seq"]) == PINNED_FLOPS


def test_dense_comparison_reads_what_it_read_before():
    wl, conf = tiny.train_cell()
    _, checks = measure(wl, SEED, 0.5, False, torch.device("cpu"),
                        time.monotonic(), bench=tiny.bench(), conf=conf)
    assert {k: c["value"] for k, c in checks.items()} == PINNED_CHECKS


def test_an_unknown_family_is_refused_by_name():
    with pytest.raises(KeyError, match="families"):
        registry.load_family("no-such-family")


def test_a_family_file_may_define_a_dataclass(tmp_path):
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "shaped.py").write_text(
        "from __future__ import annotations\n"
        "from dataclasses import dataclass\n\n\n"
        "@dataclass\nclass Shape:\n    experts: int\n")
    assert registry.load_family("shaped", tmp_path).Shape(8).experts == 8


# a second family as new files only: the dense arithmetic under another
# name, found through the lookup and nowhere else
TWIN_FAMILY = '''"""The dense family's arithmetic under another name."""
from hero_bench import registry

_dense = registry.load_family("dense")
model_config = _dense.model_config
init_scale = _dense.init_scale
train_step_flops = _dense.train_step_flops
'''
TWIN_REFERENCE = '''"""The dense reference under another name."""
from hero_bench.reference.dense import loss_and_grads  # noqa: F401
'''
TWIN_CELL = "twin-tiny-train-2x16"


def plant_twin(tmp_path):
    """A benchmark directory holding the benchmark's metric readers and,
    as new files, the family ``twin``, its reference, a configuration
    and a cell: -> (root, workload, benchmark entries)."""
    root = tmp_path / "hero_bench"
    shutil.copytree(registry.HERE / "metrics", root / "metrics")
    for sub, text in (("families", TWIN_FAMILY),
                      ("reference", TWIN_REFERENCE)):
        (root / sub).mkdir()
        (root / sub / "twin.py").write_text(text)
    wl, conf = tiny.train_cell()
    conf.update(name="twin-tiny", family="twin")
    (root / "configs").mkdir()
    (root / "configs" / "twin-tiny.json").write_text(json.dumps(conf))
    cell = {k: v for k, v in wl.items() if k != "name"}
    cell["config"] = "twin-tiny"
    (root / "workloads").mkdir()
    (root / "workloads" / f"{TWIN_CELL}.json").write_text(json.dumps(cell))
    bench = tiny.bench()
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(TWIN_CELL)
    return root, registry.load_workload(TWIN_CELL, root), bench


def test_a_planted_family_runs_a_cell_by_files_alone(tmp_path):
    root, wl, bench = plant_twin(tmp_path)
    with pytest.raises(KeyError):
        registry.load_family("twin")        # not in the benchmark's tree
    res = measure(wl, SEED, 0.5, False, torch.device("cpu"),
                  time.monotonic(), bench=bench, root=root)[0]
    assert res["correct"], res["checks"]
    assert {"train_tokens_per_s", "setup_s"} <= set(res["metrics"])


def test_a_planted_family_catches_the_half_batch_fault(tmp_path,
                                                      monkeypatch):
    from repro_torch.models import lm
    loss_fn = lm.loss_fn

    def half(params, cfg, batch):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(params, cfg, {k: v[:rows] for k, v in batch.items()})
    monkeypatch.setattr(lm, "loss_fn", half)
    root, wl, bench = plant_twin(tmp_path)
    res = measure(wl, SEED, 0.5, False, torch.device("cpu"),
                  time.monotonic(), bench=bench, root=root)[0]
    assert not res["correct"]
