"""Weight and cache bridge between the JAX package's pytrees (as numpy
arrays) and the port's modules.

The JAX params are ``{"embed", "final_norm": {"scale"}, ["lm_head"], ...}``
with every block leaf stacked on a leading layer axis: dense ``blocks``
are ``{"ln1", "attn", "ln2", "mlp"}``; hybrid ``blocks`` are ``{"ln",
"mamba"}``, plus one unstacked ``shared`` dense block; vlm ``groups`` are
``{"cross", "selfs"}`` stacked on the group axis, with ``selfs`` stacked
again inside each group; audio has ``encoder: {"blocks", "final_norm"}``
and decoder ``blocks``.  A cross block adds ``ln_x``, ``xattn`` and the
f32 scalar leaf ``xgate``.  moe has ``dense_blocks`` and ``moe_blocks``
(``{"ln1", "mla", "ln2"}`` and ``mlp`` or ``moe``) and v3 an unstacked
``mtp`` (``proj``, ``ln``, ``block``); ssm a list ``blocks_list`` of
``{"ln", "mlstm" | "slstm"}``.  The port keeps one block module per layer
with the same leaf names and layouts, so each conversion is a copy and
never a transpose; the nested leaves of a moe block's ``mla``
(``q_norm``/``kv_norm: {"scale"}``) and ``moe`` (``shared: {w_gate,
w_up, w_down}``) are stored flat (``q_norm``, ``shared_w_gate``, ...).
Caches have the same nesting on both sides (dense and audio ``layers``;
hybrid ``mamba`` and ``attn``, with the ring's int32 ``pos``; vlm
``cross_layers`` and ``self_layers``; vlm and audio ``cross_kv``; ssm
``mlstm`` and ``slstm``), stacked on a layer axis, except moe's: the
reference's ``layers: {"ckv", "krope"}`` are the column ranges of the
port's one ``layers: {"latent"}`` buffer.  The port keeps ``idx`` as a
host int.

bf16 leaves are numpy's ``bfloat16`` (registered by ml_dtypes, which the
JAX side loads); they cross as raw 16-bit words: numpy uint16 -> torch
int16 -> ``.view(torch.bfloat16)``, and back.  The round trip is
bit-exact.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import (LM, MTP, AudioLM, DenseBlock, DenseLM,
                                   Encoder, HybridLM, MambaBlock, MoEBlock,
                                   MoeLM, VlmGroup, VlmLM, XlstmBlock,
                                   XlstmLM, require_ported)

DENSE_GROUPS = ("ln1", "attn", "ln2", "mlp")
CROSS_GROUPS = ("ln_x", "xattn")
HYBRID_GROUPS = ("ln", "mamba")
MLA_NORMS = ("q_norm", "kv_norm")       # {"scale"} leaves stored flat
SHARED = "shared_"                      # moe's shared experts, flat


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


def _flat(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A moe block's ``mla`` or ``moe`` group with its nested leaves
    flattened: ``q_norm: {"scale": x}`` -> ``q_norm: x``, ``shared:
    {"w_up": x}`` -> ``shared_w_up: x``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k in MLA_NORMS:
            out[k] = v["scale"]
        elif k == "shared":
            out.update({SHARED + kk: vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`_flat`."""
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        if k in MLA_NORMS:
            out[k] = {"scale": v}
        elif k.startswith(SHARED):
            out.setdefault("shared", {})[k[len(SHARED):]] = v
        else:
            out[k] = v
    return out


def _moe_block(tree: Mapping[str, Any], dev, *idx) -> MoEBlock:
    """Block ``idx`` of a stacked DeepSeek block tree (or the unstacked
    MTP block)."""
    ffn = ({"mlp": _group(tree["mlp"], dev, *idx)} if "mlp" in tree
           else {"moe": _group(_flat(tree["moe"]), dev, *idx)})
    return MoEBlock(_group(tree["ln1"], dev, *idx),
                    _group(_flat(tree["mla"]), dev, *idx),
                    _group(tree["ln2"], dev, *idx), **ffn)


def _n_stacked(tree: Mapping[str, Any]) -> int:
    return len(tree["ln1"]["scale"])


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
    if cfg.family == "moe":
        mtp = None
        if "mtp" in tree:
            m = tree["mtp"]
            mtp = MTP(to_torch(m["proj"], dev), _group(m["ln"], dev),
                      _moe_block(m["block"], dev))
        return MoeLM(embed, final_norm,
                     *([_moe_block(tree[k], dev, i)
                        for i in range(_n_stacked(tree[k]))]
                       for k in ("dense_blocks", "moe_blocks")),
                     lm_head, mtp)
    if cfg.family == "ssm":
        return XlstmLM(embed, final_norm,
                       [XlstmBlock(**{k: _group(v, dev)
                                      for k, v in b.items()})
                        for b in tree["blocks_list"]], lm_head)
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


def _moe_block_tree(blk: MoEBlock) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"ln1": dict(blk.ln1),
                            "mla": _nest(dict(blk.mla)),
                            "ln2": dict(blk.ln2)}
    if blk.moe is not None:
        tree["moe"] = _nest(dict(blk.moe))
    else:
        tree["mlp"] = dict(blk.mlp)
    return tree


def _stack(trees: Sequence[Any]) -> Any:
    """Same-shaped trees of tensors -> one tree stacked on a new axis 0."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))


def _to_numpy_tree(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy_tree(v) for v in tree]
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
    elif isinstance(model, MoeLM):
        tree["dense_blocks"] = _stack([_moe_block_tree(b)
                                       for b in model.dense_blocks])
        tree["moe_blocks"] = _stack([_moe_block_tree(b)
                                     for b in model.moe_blocks])
        if model.mtp is not None:
            tree["mtp"] = {"proj": model.mtp.proj, "ln": dict(model.mtp.ln),
                           "block": _moe_block_tree(model.mtp.block)}
    elif isinstance(model, XlstmLM):
        tree["blocks_list"] = [
            {k: dict(getattr(b, k)) for k in ("ln", "mlstm", "slstm")
             if getattr(b, k) is not None} for b in model.blocks]
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
    """A JAX cache of any family -> the port's (``idx`` a host int; moe's
    ``ckv`` and ``krope`` side by side in one ``latent`` row)."""
    dev = resolve_device(device)
    out = {k: (int(np.asarray(v)) if k == "idx" else _group(v, dev))
           for k, v in cache.items()}
    lay = out.get("layers", {})
    if "ckv" in lay:
        out["layers"] = {"latent": torch.cat([lay["ckv"], lay["krope"]],
                                             dim=-1)}
    return out


def cache_from_torch(cache: Mapping[str, Any],
                     cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """The port's cache -> the JAX layout; a moe cache needs ``cfg`` to
    split each latent row into ``ckv`` (kv_lora_rank) and ``krope``."""
    out = {k: (np.asarray(v, dtype=np.int32) if k == "idx"
               else _numpy_group(v))
           for k, v in cache.items()}
    lat = out.get("layers", {}).get("latent")
    if lat is not None:
        if cfg is None:
            raise ValueError("cache_from_torch: a moe cache needs its cfg")
        r = cfg.mla.kv_lora_rank
        out["layers"] = {"ckv": np.ascontiguousarray(lat[..., :r]),
                         "krope": np.ascontiguousarray(lat[..., r:])}
    return out
