"""PyTorch/CUDA port of the HeRo agentic-RAG system.

The JAX package ``repro`` is the reference; this package recomputes its
main path with torch tensors and hand-written CUDA kernels for Hopper
(``repro_torch.kernels``).  It imports torch, numpy and the standard
library only — never ``jax`` and nothing of ``repro``: the control-plane
modules it shares with the reference (``configs``, ``core``, ``api``,
``analysis``, ``rag.{tokenizer,chunker,datasets,workflow,stages}``,
``serving.executor``) are textual copies with ``repro.`` renamed.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked for.  With no GPU and no explicit device this raises — the
    port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is visible; "
                "pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported dtype {name!r}")
    return dtypes[name]


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded generator on ``device`` (weights are drawn where they live)."""
    return torch.Generator(device=device).manual_seed(seed)


__all__ = ["resolve_device", "torch_dtype", "make_generator", "DeviceLike"]
