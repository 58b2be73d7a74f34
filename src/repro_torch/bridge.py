"""Weight and cache bridge between the JAX package's pytrees (as numpy
arrays) and the port's modules.

The JAX params are ``{"embed", "final_norm": {"scale"}, ["lm_head"],
"blocks": ...}`` with every block leaf stacked on a leading layer axis:
dense ``blocks`` are ``{"ln1", "attn", "ln2", "mlp"}``; hybrid ``blocks``
are ``{"ln", "mamba"}``, plus one unstacked ``shared`` dense block.  The
port keeps one block module per layer with the same leaf names and
layouts, so each conversion is a copy and never a transpose.  Caches have
the same nesting on both sides (dense ``layers``; hybrid ``mamba`` and
``attn``, stacked on a layer axis); the port keeps ``idx`` as a host int.

bf16 leaves are numpy's ``bfloat16`` (registered by ml_dtypes, which the
JAX side loads); they cross as raw 16-bit words: numpy uint16 -> torch
int16 -> ``.view(torch.bfloat16)``, and back.  The round trip is
bit-exact.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (LM, DenseBlock, DenseLM, HybridLM,
                                   MambaBlock, require_ported)

DENSE_GROUPS = ("ln1", "attn", "ln2", "mlp")
HYBRID_GROUPS = ("ln", "mamba")


def to_torch(a: Any, device: DeviceLike = "cpu") -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # writable; never aliases
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(
            np.dtype("bfloat16"))
    return t.numpy()


def _group(tree: Mapping[str, Any], dev, i=None) -> Dict[str, torch.Tensor]:
    return {k: to_torch(v if i is None else v[i], dev)
            for k, v in tree.items()}


def params_to_torch(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> LM:
    """JAX params (numpy leaves) -> :class:`DenseLM` or :class:`HybridLM`
    on ``device``."""
    require_ported(cfg)
    dev = resolve_device(device)
    stacked = tree["blocks"]
    final_norm = _group(tree["final_norm"], dev)
    lm_head = to_torch(tree["lm_head"], dev) if "lm_head" in tree else None
    embed = to_torch(tree["embed"], dev)
    if cfg.family == "hybrid":
        blocks = [MambaBlock(*(_group(stacked[grp], dev, i)
                               for grp in HYBRID_GROUPS))
                  for i in range(cfg.num_layers)]
        shared = DenseBlock(*(_group(tree["shared"][grp], dev)
                              for grp in DENSE_GROUPS))
        return HybridLM(embed, final_norm, blocks, shared, lm_head)
    blocks = [DenseBlock(*(_group(stacked[grp], dev, i)
                           for grp in DENSE_GROUPS))
              for i in range(cfg.num_layers)]
    return DenseLM(embed, final_norm, blocks, lm_head)


def _numpy_group(pdict) -> Dict[str, Any]:
    return {k: to_numpy(v) for k, v in pdict.items()}


def params_from_torch(model: LM) -> Dict[str, Any]:
    """:class:`DenseLM` / :class:`HybridLM` -> the JAX pytree layout (numpy
    leaves, stacked blocks)."""
    groups = HYBRID_GROUPS if isinstance(model, HybridLM) else DENSE_GROUPS
    blocks = {grp: {name: to_numpy(torch.stack(
                        [getattr(b, grp)[name] for b in model.blocks]))
                    for name in getattr(model.blocks[0], grp)}
              for grp in groups}
    tree: Dict[str, Any] = {
        "embed": to_numpy(model.embed),
        "final_norm": _numpy_group(model.final_norm),
        "blocks": blocks}
    if isinstance(model, HybridLM):
        tree["shared"] = {grp: _numpy_group(getattr(model.shared, grp))
                          for grp in DENSE_GROUPS}
    if model.lm_head is not None:
        tree["lm_head"] = to_numpy(model.lm_head)
    return tree


def cache_to_torch(cache: Mapping[str, Any],
                   device: DeviceLike = None) -> Dict[str, Any]:
    """A JAX cache of either family -> the port's (``idx`` a host int)."""
    dev = resolve_device(device)
    return {k: (int(np.asarray(v)) if k == "idx" else _group(v, dev))
            for k, v in cache.items()}


def cache_from_torch(cache: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: (np.asarray(v, dtype=np.int32) if k == "idx"
                else _numpy_group(v))
            for k, v in cache.items()}
