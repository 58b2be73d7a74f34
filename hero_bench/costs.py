"""Operations and bytes of the port's attention kernel (K2) and its
backward, from the shapes of each call (a model family's FLOPs a train
step are in ``families/<family>.py``).  The kernels' arithmetic is that of
``repro_torch.kernels.ops._flash_cost`` / ``flash_bwd_cost``, copied
here and frozen so that a change to the program cannot change the
yardstick.  Each input byte counts as read
once and each output byte as written once; causal work counts only the
visible pairs."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from hero_bench import peaks


@dataclass(frozen=True)
class Cost:
    flops: float
    nbytes: float
    dtype: str          # the arithmetic type that prices the flops

    def bound_s(self) -> float:
        """Least time on the chip: the larger of the compute and the
        memory bound."""
        return max(self.flops / peaks.flops_peak(self.dtype),
                   self.nbytes / peaks.HBM_BYTES_PER_S)


def visible_pairs(sq: int, kv_len: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs a causal mask leaves, query i at q_offset + i."""
    if not causal:
        return sq * kv_len
    total = 0
    for i in range(sq):
        total += max(0, min(kv_len, q_offset + i + 1))
    return total


def k2_forward(b: int, sq: int, h: int, n: int, e: int, ev: int,
               kv_len: int, causal: bool, q_offset: int, itemsize: int,
               dtype: str, lse: bool = False) -> Cost:
    """K2 (flash attention): QK over e and PV over ev on the visible
    pairs; q and the output once, the first kv_len K/V rows once (and
    the f32 LSE where the training forward writes it)."""
    flops = 2 * b * h * (e + ev) * visible_pairs(sq, kv_len, causal,
                                                 q_offset)
    nbytes = ((b * sq * h * e + b * sq * h * ev) * itemsize
              + b * kv_len * n * (e + ev) * itemsize
              + (4 * b * h * sq if lse else 0))
    return Cost(flops, nbytes, dtype)


def k2_backward(b: int, sq: int, h: int, n: int, e: int, ev: int,
                kv_len: int, causal: bool, q_offset: int, itemsize: int,
                dtype: str) -> Cost:
    """K2's backward: S recomputed, dQ and dK over e, dP and dV over ev
    (2·pairs·h·b·(3e + 2ev)); q, k, v, o, do and the LSE read once, dq,
    dk, dv written once."""
    flops = 2 * b * h * (3 * e + 2 * ev) * visible_pairs(sq, kv_len, causal,
                                                         q_offset)
    qb = b * sq * h * e * itemsize
    ob = b * sq * h * ev * itemsize
    kb = b * kv_len * n * e * itemsize
    vb = b * kv_len * n * ev * itemsize
    return Cost(flops, 2 * (qb + ob + kb + vb) + 4 * b * h * sq, dtype)


def itemsize_and_type(t) -> Tuple[int, str]:
    """Bytes an element of tensor ``t`` and the arithmetic type that
    prices a kernel over it."""
    import torch
    return t.element_size(), ("float32" if t.dtype == torch.float32
                              else "bfloat16")
