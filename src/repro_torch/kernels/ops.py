"""Public kernel entry points, and the one table of the port's kernels.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written kernel, which raises on anything it
does not take.  There is no fallback from one to the other.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
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
           ("decode_split", "decode_combine")),
    Kernel("flash_attention", _flash,
           "src/repro/kernels/flash_attention.py:26", ("flash_fwd",)),
    Kernel("topk_retrieval", _topk,
           "src/repro/kernels/topk_retrieval.py:22",
           ("topk_partial", "topk_merge")),
)


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    if _on_card(q):
        return _decode.decode_attention(q, k_cache, v_cache, lengths)
    return ref.decode_attention_ref(q, k_cache, v_cache, lengths)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    if _on_card(q):
        return _flash.flash_attention(q, k, v, causal=causal,
                                      q_offset=q_offset, kv_len=kv_len)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)


def topk_retrieval(queries: torch.Tensor, corpus: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_card(queries):
        return _topk.topk_retrieval(queries, corpus, k)
    return ref.topk_retrieval_ref(queries, corpus, k)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.module.launches.count for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.module.launches.reset()
