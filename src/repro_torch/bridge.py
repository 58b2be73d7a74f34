"""Weight and cache bridge between the JAX package's pytrees (as numpy
arrays) and the port's modules.

The JAX dense params are ``{"embed", "final_norm": {"scale"}, ["lm_head"],
"blocks": {"ln1", "attn", "ln2", "mlp"}}`` with every block leaf stacked
on a leading layer axis; the port keeps one :class:`DenseBlock` per layer
with the same leaf names and layouts, so each conversion is a copy and
never a transpose.  The dense cache is
``{"idx", "layers": {"k", "v": (L,b,S,n,e)}}`` on both sides (the port
keeps ``idx`` as a host int).

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
from repro_torch.models.lm import DenseBlock, DenseLM, _require_dense

GROUPS = ("ln1", "attn", "ln2", "mlp")


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


def params_to_torch(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> DenseLM:
    """JAX dense params (numpy leaves) -> :class:`DenseLM` on ``device``."""
    _require_dense(cfg)
    dev = resolve_device(device)
    stacked = tree["blocks"]
    blocks = [DenseBlock(*({name: to_torch(leaf[i], dev)
                            for name, leaf in stacked[grp].items()}
                           for grp in GROUPS))
              for i in range(cfg.num_layers)]
    final_norm = {k: to_torch(v, dev) for k, v in tree["final_norm"].items()}
    lm_head = to_torch(tree["lm_head"], dev) if "lm_head" in tree else None
    return DenseLM(to_torch(tree["embed"], dev), final_norm, blocks, lm_head)


def params_from_torch(model: DenseLM) -> Dict[str, Any]:
    """:class:`DenseLM` -> the JAX pytree layout (numpy leaves, stacked
    blocks)."""
    blocks = {grp: {name: to_numpy(torch.stack(
                        [getattr(b, grp)[name] for b in model.blocks]))
                    for name in getattr(model.blocks[0], grp)}
              for grp in GROUPS}
    tree: Dict[str, Any] = {
        "embed": to_numpy(model.embed),
        "final_norm": {k: to_numpy(v) for k, v in model.final_norm.items()},
        "blocks": blocks}
    if model.lm_head is not None:
        tree["lm_head"] = to_numpy(model.lm_head)
    return tree


def cache_to_torch(cache: Mapping[str, Any],
                   device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    return {"idx": int(np.asarray(cache["idx"])),
            "layers": {k: to_torch(v, dev)
                       for k, v in cache["layers"].items()}}


def cache_from_torch(cache: Mapping[str, Any]) -> Dict[str, Any]:
    return {"idx": np.asarray(cache["idx"], dtype=np.int32),
            "layers": {k: to_numpy(v) for k, v in cache["layers"].items()}}
