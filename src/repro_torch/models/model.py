"""Public model facade — port of ``repro/models/model.py`` (serving part):
``build_model(cfg, device)`` -> :class:`Model` with ``init``, ``apply``,
``prefill``, ``decode_step`` and ``init_cache``."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import DeviceLike, make_generator, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable[[int], lm.DenseLM]
    apply: Callable[..., Tuple[torch.Tensor, torch.Tensor, Optional[lm.Cache]]]
    prefill: Callable[..., Tuple[torch.Tensor, lm.Cache]]
    decode_step: Callable[..., Tuple[torch.Tensor, lm.Cache]]
    init_cache: Callable[[int, int], lm.Cache]


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    dev = resolve_device(device)

    def init(seed: int) -> lm.DenseLM:
        return lm.init_params(cfg, make_generator(seed, dev), dev)

    def apply(params, batch, *, mode="train", cache=None):
        return lm.apply(params, cfg, batch, mode=mode, cache=cache)

    def prefill(params, batch, cache):
        logits, _, new_cache = lm.apply(params, cfg, batch, mode="prefill",
                                        cache=cache)
        return logits, new_cache

    def decode_step(params, tokens: torch.Tensor, cache,
                    extras: Optional[dict[str, Any]] = None):
        batch = {"tokens": tokens, **(extras or {})}
        logits, _, new_cache = lm.apply(params, cfg, batch, mode="decode",
                                        cache=cache)
        return logits[:, -1], new_cache

    def init_cache(batch_size: int, max_len: int) -> lm.Cache:
        return lm.init_cache(cfg, batch_size, max_len, dev)

    return Model(cfg, dev, init, apply, prefill, decode_step, init_cache)
