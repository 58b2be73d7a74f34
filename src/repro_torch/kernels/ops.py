"""Public kernel entry points, the table of the port's kernels and the
table of its backward kernels.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written kernel, which raises on anything it
does not take.  There is no fallback from one to the other.

Gradients: on the CPU the plain versions are differentiated by
autograd.  On the card, when grad mode is on and an input requires a
gradient, ``flash_attention`` (no window or MLA mode) runs
``flash_attention.FlashAttentionFn``, whose backward is K2's backward
kernel, and ``ssd_chunk`` runs ``ssd_chunk.SsdChunkFn``, whose backward
is K5's backward kernel; every other kernel call raises a
``RuntimeError`` naming the kernel (K1, K3, K4, K2's window and MLA
modes): their outputs carry no ``grad_fn``, so a gradient would silently
stop at them.  Under ``no_grad`` nothing is guarded.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import int8_matmul as _int8
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import ssd_chunk_bwd as _ssd_bwd
from repro_torch.kernels import topk_retrieval as _topk


@dataclass(frozen=True)
class Kernel:
    """One hand-written kernel.  ``module`` holds the wrapper (named like
    the kernel) and its launch counter; ``source`` is ``csrc/<name>.cu``;
    ``symbols`` are its ``__global__`` functions, as a device trace names
    them."""
    name: str
    module: ModuleType
    replaces: str               # the TPU kernel it ports, file:line
    symbols: Tuple[str, ...]

    @property
    def source(self) -> str:
        """Path of the CUDA source, relative to the repository root."""
        return f"src/repro_torch/kernels/csrc/{self.name}.cu"


KERNELS = (
    Kernel("decode_attention", _decode,
           "src/repro/kernels/decode_attention.py:25",
           ("decode_attn", "decode_mla", "decode_mla_mma",
            "decode_mla_combine")),
    Kernel("flash_attention", _flash,
           "src/repro/kernels/flash_attention.py:26",
           ("flash_fwd_wgmma", "flash_combine", "flash_fwd", "flash_mla",
            "flash_mla_mma", "flash_mla_combine")),
    Kernel("topk_retrieval", _topk,
           "src/repro/kernels/topk_retrieval.py:22",
           ("topk_partial", "topk_merge")),
    Kernel("int8_matmul", _int8,
           "src/repro/kernels/int8_matmul.py:22",
           ("int8_mm_wgmma", "int8_mm")),
    Kernel("ssd_chunk", _ssd,
           "src/repro/kernels/mamba2_scan.py:23",
           ("ssd_decode", "ssd_chunk_mma", "ssd_chunk_fwd")),
)


@dataclass(frozen=True)
class BackwardKernel:
    """One hand-written backward kernel: the gradient of the ``KERNELS``
    row ``differentiates``.  ``autodiff_of`` is the JAX function
    (file:line) whose XLA autodiff it replaces: the JAX package has no
    backward Pallas kernel.  ``module`` holds the wrapper (named like the
    kernel) and its own launch counter."""
    name: str
    module: ModuleType
    differentiates: str
    autodiff_of: str
    symbols: Tuple[str, ...]

    @property
    def source(self) -> str:
        return f"src/repro_torch/kernels/csrc/{self.name}.cu"


BACKWARD_KERNELS = (
    BackwardKernel("flash_attention_bwd", _flash_bwd, "flash_attention",
                   "src/repro/models/layers.py:116",
                   ("flash_bwd_prep", "flash_bwd_dkdv_wgmma",
                    "flash_bwd_dq_wgmma", "flash_bwd_delta", "flash_bwd_dkdv",
                    "flash_bwd_dq", "flash_bwd_sum")),
    BackwardKernel("ssd_chunk_bwd", _ssd_bwd, "ssd_chunk",
                   "src/repro/models/ssm.py:78",
                   ("ssd_bwd_tiles", "ssd_bwd_finish")),
)


def _wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if a kernel without a backward is asked for a gradient."""
    if _wants_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward kernel: an input requires a gradient "
            f"under grad mode, and the kernel's output would drop it "
            f"(run under torch.no_grad(), or train this path on the CPU)")


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     kv_positions: Optional[torch.Tensor] = None,
                     q_pos: Optional[torch.Tensor] = None,
                     window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    if _on_card(q):
        _no_backward("decode_attention (K1)", q, k_cache, v_cache)
        fn = _decode.decode_attention
    else:
        fn = ref.decode_attention_ref
    return fn(q, k_cache, v_cache, lengths, kv_positions=kv_positions,
              q_pos=q_pos, window=window, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    if _on_card(q):
        mla = scale is not None or v.shape[-1] != k.shape[-1]
        if window == 0 and kv_positions is None and not mla:
            if _wants_grad(q, k, v):
                return _flash.FlashAttentionFn.apply(q, k, v, causal,
                                                     q_offset, kv_len)
        else:
            _no_backward(f"flash_attention (K2) in "
                         f"{'MLA' if mla else 'window'} mode", q, k, v)
        fn = _flash.flash_attention
    else:
        fn = ref.flash_attention_ref
    return fn(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
              kv_positions=kv_positions, window=window, scale=scale)


def topk_retrieval(queries: torch.Tensor, corpus: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_card(queries):
        _no_backward("topk_retrieval (K3)", queries, corpus)
        return _topk.topk_retrieval(queries, corpus, k)
    return ref.topk_retrieval_ref(queries, corpus, k)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor,
              dA: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_card(x):
        if _wants_grad(x, dt, B, C, dA):
            return _ssd.SsdChunkFn.apply(x, dt, B, C, dA)
        return _ssd.ssd_chunk(x, dt, B, C, dA)
    return ref.ssd_chunk_ref(x, dt, B, C, dA)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if _on_card(x):
        _no_backward("int8_matmul (K4)", x, w, sx, sw)
        return _int8.int8_matmul(x, w, sx, sw, out_dtype)
    return ref.int8_matmul_ref(x, w, sx, sw, out_dtype)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.module.launches.count for k in KERNELS}


def mla_launch_counts() -> Dict[str, int]:
    """Launches of K1's and K2's MLA mode (a share of their counts)."""
    return {k.name: k.module.mla_launches.count for k in KERNELS
            if hasattr(k.module, "mla_launches")}


def backward_launch_counts() -> Dict[str, int]:
    return {k.name: k.module.launches.count for k in BACKWARD_KERNELS}


def reset_launch_counts() -> None:
    for k in BACKWARD_KERNELS:
        k.module.launches.reset()
    for k in KERNELS:
        k.module.launches.reset()
        if hasattr(k.module, "mla_launches"):
            k.module.mla_launches.reset()
