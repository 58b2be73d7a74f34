"""K2: GQA flash-attention forward on Hopper — wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py`` and adds
the two arguments prefill into a cache needs: ``q_offset`` (query ``i`` sits
at position ``q_offset + i``) and ``kv_len`` (keys at ``>= kv_len`` are
masked).  The causal mask is ``q_offset + qpos >= kpos``.  k/v may be any
view with a unit-stride head dim, such as the prefix ``cache[:, :L]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, L, P, require

HEAD_DIMS = (16, 64, 128)
_SIG = {"repro_flash_attention": [P] * 4 + [I] * 9 + [L] * 9 + [P]}

launches = _build.LaunchCounter()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (b, sq, h, e); k/v (b, sk, n, e) with h % n == 0 -> (b, sq, h, e)
    in q's dtype."""
    _build.check_cuda("flash_attention", [q, k, v])
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            f"flash_attention: bad shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, e = q.shape
    kb, sk, n, ke = k.shape
    kv_len = sk if kv_len is None else int(kv_len)
    require(kb == b and ke == e and h % n == 0,
            f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    require(e in HEAD_DIMS, f"flash_attention: head dim {e} not in "
            f"{HEAD_DIMS}")
    require(0 <= kv_len <= sk and q_offset >= 0,
            f"flash_attention: kv_len {kv_len} / q_offset {q_offset} "
            f"out of range for sk={sk}")
    require(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
            and v.dtype == q.dtype,
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
            f"unsupported")
    require(q.stride(-1) == 1 and k.stride(-1) == 1 and v.stride(-1) == 1,
            "flash_attention: inputs must be unit-stride on the head dim")
    out = torch.empty((b, sq, h, e), dtype=q.dtype, device=q.device)
    lib = _build.library("flash_attention", _SIG)
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, sq, h, n, e, kv_len, q_offset,
        int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention")
    launches.add()
    return out


def visible_pairs(sq: int, kv_len: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs the mask leaves visible, per (batch, head)."""
    if not causal:
        return sq * kv_len
    return sum(max(0, min(kv_len, q_offset + i + 1)) for i in range(sq))


def flops(q: torch.Tensor, kv_len: int, causal: bool, q_offset: int) -> int:
    """QK and PV multiply-adds over the visible pairs (2 flops each)."""
    b, sq, h, e = q.shape
    return 4 * b * h * e * visible_pairs(sq, kv_len, causal, q_offset)


def bytes_moved(q: torch.Tensor, k: torch.Tensor, kv_len: int) -> int:
    """q and the output once, and the visible K/V rows once."""
    b, _, n, e = k.shape
    return (2 * q.numel() * q.element_size()
            + 2 * b * kv_len * n * e * k.element_size())
