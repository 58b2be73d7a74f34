"""Weight and cache bridge between the JAX package's pytrees (as numpy
arrays) and the port's modules.

The JAX params are ``{"embed", "final_norm": {"scale"}, ["lm_head"], ...}``
with every block leaf stacked on a leading layer axis: dense ``blocks``
are ``{"ln1", "attn", "ln2", "mlp"}``; hybrid ``blocks`` are ``{"ln",
"mamba"}``, plus one unstacked ``shared`` dense block; vlm ``groups`` are
``{"cross", "selfs"}`` stacked on the group axis, with ``selfs`` stacked
again inside each group; audio has ``encoder: {"blocks", "final_norm"}``
and decoder ``blocks``.  A cross block adds ``ln_x``, ``xattn`` and the
f32 scalar leaf ``xgate``.  The port keeps one block module per layer
with the same leaf names and layouts, so each conversion is a copy and
never a transpose.  Caches have the same nesting on both sides (dense and
audio ``layers``; hybrid ``mamba`` and ``attn``, with the ring's int32
``pos``; vlm ``cross_layers`` and ``self_layers``; vlm and audio
``cross_kv``), stacked on a layer axis; the port keeps ``idx`` as a host
int.

bf16 leaves are numpy's ``bfloat16`` (registered by ml_dtypes, which the
JAX side loads); they cross as raw 16-bit words: numpy uint16 -> torch
int16 -> ``.view(torch.bfloat16)``, and back.  The round trip is
bit-exact.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (LM, AudioLM, DenseBlock, DenseLM, Encoder,
                                   HybridLM, MambaBlock, VlmGroup, VlmLM,
                                   require_ported)

DENSE_GROUPS = ("ln1", "attn", "ln2", "mlp")
CROSS_GROUPS = ("ln_x", "xattn")
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


def _group(tree: Mapping[str, Any], dev, *idx) -> Dict[str, torch.Tensor]:
    """A dict of leaves, each indexed by ``idx`` on its stacked axes."""
    return {k: to_torch(v[idx] if idx else v, dev) for k, v in tree.items()}


def _block(tree: Mapping[str, Any], dev, *idx) -> DenseBlock:
    """Dense (or cross) block ``idx`` of a stacked block tree."""
    cross = {}
    if "xattn" in tree:
        cross = {g: _group(tree[g], dev, *idx) for g in CROSS_GROUPS}
        cross["xgate"] = to_torch(tree["xgate"][idx] if idx
                                  else tree["xgate"], dev)
    return DenseBlock(*(_group(tree[g], dev, *idx) for g in DENSE_GROUPS),
                      **cross)


def params_to_torch(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> LM:
    """JAX params (numpy leaves) -> the family's LM module on ``device``."""
    require_ported(cfg)
    dev = resolve_device(device)
    final_norm = _group(tree["final_norm"], dev)
    lm_head = to_torch(tree["lm_head"], dev) if "lm_head" in tree else None
    embed = to_torch(tree["embed"], dev)
    if cfg.family == "hybrid":
        stacked = tree["blocks"]
        blocks = [MambaBlock(*(_group(stacked[grp], dev, i)
                               for grp in HYBRID_GROUPS))
                  for i in range(cfg.num_layers)]
        return HybridLM(embed, final_norm, blocks,
                        _block(tree["shared"], dev), lm_head)
    if cfg.family == "vlm":
        g = tree["groups"]
        every = cfg.vlm.cross_attn_every
        groups = [VlmGroup(_block(g["cross"], dev, i),
                           [_block(g["selfs"], dev, i, j)
                            for j in range(every - 1)])
                  for i in range(cfg.num_layers // every)]
        return VlmLM(embed, final_norm, groups, lm_head)
    if cfg.family == "audio":
        enc = tree["encoder"]
        encoder = Encoder([_block(enc["blocks"], dev, i)
                           for i in range(cfg.encdec.encoder_layers)],
                          _group(enc["final_norm"], dev))
        return AudioLM(embed, final_norm, encoder,
                       [_block(tree["blocks"], dev, i)
                        for i in range(cfg.num_layers)], lm_head)
    return DenseLM(embed, final_norm,
                   [_block(tree["blocks"], dev, i)
                    for i in range(cfg.num_layers)], lm_head)


def _numpy_group(pdict) -> Dict[str, Any]:
    return {k: to_numpy(v) for k, v in pdict.items()}


def _block_tree(blk: DenseBlock) -> Dict[str, Any]:
    """One block -> its JAX subtree of torch tensors."""
    tree: Dict[str, Any] = {g: dict(getattr(blk, g)) for g in DENSE_GROUPS}
    if blk.xattn is not None:
        tree.update({g: dict(getattr(blk, g)) for g in CROSS_GROUPS},
                    xgate=blk.xgate)
    return tree


def _stack(trees: Sequence[Any]) -> Any:
    """Same-shaped trees of tensors -> one tree stacked on a new axis 0."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))


def _to_numpy_tree(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return to_numpy(tree)


def params_from_torch(model: LM) -> Dict[str, Any]:
    """An LM module -> the JAX pytree layout (numpy leaves, stacked
    blocks)."""
    tree: Dict[str, Any] = {"embed": model.embed,
                            "final_norm": dict(model.final_norm)}
    if isinstance(model, HybridLM):
        tree["blocks"] = _stack([{g: dict(getattr(b, g))
                                  for g in HYBRID_GROUPS}
                                 for b in model.blocks])
        tree["shared"] = _block_tree(model.shared)
    elif isinstance(model, VlmLM):
        tree["groups"] = _stack([
            {"cross": _block_tree(g.cross),
             "selfs": _stack([_block_tree(b) for b in g.selfs])}
            for g in model.groups])
    else:
        tree["blocks"] = _stack([_block_tree(b) for b in model.blocks])
        if isinstance(model, AudioLM):
            tree["encoder"] = {
                "blocks": _stack([_block_tree(b)
                                  for b in model.encoder.blocks]),
                "final_norm": dict(model.encoder.final_norm)}
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head
    return _to_numpy_tree(tree)


def cache_to_torch(cache: Mapping[str, Any],
                   device: DeviceLike = None) -> Dict[str, Any]:
    """A JAX cache of any ported family -> the port's (``idx`` a host
    int)."""
    dev = resolve_device(device)
    return {k: (int(np.asarray(v)) if k == "idx" else _group(v, dev))
            for k, v in cache.items()}


def cache_from_torch(cache: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: (np.asarray(v, dtype=np.int32) if k == "idx"
                else _numpy_group(v))
            for k, v in cache.items()}
