"""Public model facade — port of ``repro/models/model.py``:
``build_model(cfg, device)`` -> :class:`Model` with ``init``, ``apply``,
``loss_fn``, ``prefill``, ``decode_step`` and ``init_cache``, for every
family of ``lm.PORTED_FAMILIES`` (dense, hybrid, vlm, audio, moe, ssm).
A vlm or audio prefill takes the source in its batch (``vision_embeds``
or ``audio_frames``) and stores its cross k/v in the cache, which
``decode_step`` reads; ``extras`` pass further batch keys through.

``input_specs(cfg, shape)`` gives meta tensors in place of every input of
one (arch x shape) dry-run cell, and ``make_step_fn(cfg, shape)`` the
function the dry-run runs on them (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch import (DeviceLike, make_generator, resolve_device,
                         torch_dtype)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., lm.LM]
    apply: Callable[..., Tuple[torch.Tensor, torch.Tensor, Optional[lm.Cache]]]
    loss_fn: Callable[[lm.LM, Mapping[str, torch.Tensor]],
                      Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    prefill: Callable[..., Tuple[torch.Tensor, lm.Cache]]
    decode_step: Callable[..., Tuple[torch.Tensor, lm.Cache]]
    init_cache: Callable[[int, int], lm.Cache]


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    lm.require_ported(cfg)
    dev = resolve_device(device)

    def init(seed: int, trainable: bool = False) -> lm.LM:
        return lm.init_params(cfg, make_generator(seed, dev), dev, trainable)

    def apply(params, batch, *, mode="train", cache=None):
        return lm.apply(params, cfg, batch, mode=mode, cache=cache)

    def loss_fn(params, batch):
        return lm.loss_fn(params, cfg, batch)

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

    return Model(cfg, dev, init, apply, loss_fn, prefill, decode_step,
                 init_cache)


# ---------------------------------------------------------------------------
# dry-run input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta tensors for one (arch x shape) dry-run cell, the reference's
    ``ShapeDtypeStruct``s: train {"batch": {"tokens", "labels"}}, prefill
    {"batch": {"tokens"}} (each (B, S) int64, the port's index type, with
    the vlm's ``vision_embeds`` or the audio model's ``audio_frames`` in
    ``cfg.dtype``); decode {"tokens": (B, 1), "cache": the whole cache at
    length S}."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    dt = torch_dtype(cfg.dtype)

    def tokens(s):
        return torch.empty((B, s), dtype=torch.int64, device=meta)

    def frontends():
        ex = {}
        if cfg.vlm.enabled:
            ex["vision_embeds"] = torch.empty(
                (B, cfg.vlm.vision_tokens, cfg.vlm.vision_dim), dtype=dt,
                device=meta)
        if cfg.encdec.enabled:
            ex["audio_frames"] = torch.empty(
                (B, cfg.encdec.source_positions, cfg.d_model), dtype=dt,
                device=meta)
        return ex

    if shape.kind == "train":
        return {"batch": {"tokens": tokens(S), "labels": tokens(S),
                          **frontends()}}
    if shape.kind == "prefill":
        return {"batch": {"tokens": tokens(S), **frontends()}}
    return {"tokens": tokens(1), "cache": lm.init_cache(cfg, B, S, meta)}


def make_step_fn(cfg: ModelConfig, shape: ShapeConfig):
    """The function the dry-run runs for this cell: the loss and every
    parameter's gradient for train shapes, the forward's last logits for
    prefill, one decode step for decode shapes."""
    if shape.kind == "train":
        def train_step(params: lm.LM, batch):
            loss, _ = lm.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, list(params.parameters()))
            return loss, grads
        return train_step

    if shape.kind == "prefill":
        def prefill_step(params: lm.LM, batch):
            with torch.no_grad():
                logits, _, _ = lm.apply(params, cfg, batch, mode="train")
            return logits[:, -1]
        return prefill_step

    def serve_step(params: lm.LM, tokens: torch.Tensor, cache: lm.Cache):
        logits, _, new_cache = lm.apply(params, cfg, {"tokens": tokens},
                                        mode="decode", cache=cache)
        return logits[:, -1], new_cache
    return serve_step
