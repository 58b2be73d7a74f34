"""K2's backward on Hopper — wrapper of ``csrc/flash_attention_bwd.cu``.

The gradients of K2 (:func:`flash_attention.flash_attention`, no window or
MLA mode): ``flash_bwd_delta`` (D = rowsum(dO ⊙ O)), ``flash_bwd_dkdv``
(a block per (b, query head, 64 keys), walking the head's query tiles)
and ``flash_bwd_dq`` (a block per (b, head, 64 queries, key split),
walking its key tiles), two passes with no float atomics; with GQA
(g > 1) or a split key range (:func:`plan`) ``flash_bwd_sum`` adds the
f32 shares in a fixed order, so a gradient is the same in every run.
The JAX package has no backward Pallas kernel: it differentiates
``repro/models/layers.py::mha`` with XLA; ``kernels/ref.py::
flash_attention_bwd_ref`` is the plain version, step by step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P, require

HEAD_DIMS = (16, 64, 128)
TILE = 64               # query rows and keys of a tile
SMS = 132               # streaming multiprocessors of an H100 SXM
MIN_SPLIT_TILES = 2     # key tiles a dQ split must have
_SIG = {"repro_flash_attention_bwd": [P] * 12 + [I] * 12 + [P]}

launches = _build.LaunchCounter()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool,
                        q_offset: int = 0, kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, o, do (b, sq, h, e), k, v (b, sk, n, e) with h % n == 0, one
    dtype (bf16 or f32); lse f32 (b, h, sq), the forward's -> (dq, dk, dv)
    in the inputs' dtype.  Query i sits at ``q_offset + i``; keys at or
    past ``kv_len`` are masked."""
    _build.check_cuda("flash_attention_bwd", [q, k, v, o, do, lse])
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape
            and o.shape == q.shape and do.shape == q.shape,
            f"flash_attention_bwd: bad shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, o {tuple(o.shape)}, "
            f"do {tuple(do.shape)}")
    b, sq, h, e = q.shape
    kb, sk, n, ke = k.shape
    kv_len = sk if kv_len is None else int(kv_len)
    require(kb == b and ke == e and h % n == 0 and sq >= 1 and sk >= 1,
            f"flash_attention_bwd: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    require(e in HEAD_DIMS, f"flash_attention_bwd: head dim {e} not in "
            f"{HEAD_DIMS}")
    require(0 <= kv_len <= sk and q_offset >= 0,
            f"flash_attention_bwd: kv_len {kv_len} / q_offset {q_offset} "
            f"out of range for sk={sk}")
    require(q.dtype in _build.DTYPE_CODES
            and all(t.dtype == q.dtype for t in (k, v, o, do)),
            f"flash_attention_bwd: dtypes "
            f"{[str(t.dtype) for t in (q, k, v, o, do)]} unsupported")
    require(lse.shape == (b, h, sq) and lse.dtype == torch.float32,
            f"flash_attention_bwd: lse must be f32 {(b, h, sq)}, got "
            f"{lse.dtype} {tuple(lse.shape)}")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, sq), **f32)
    part_kv = torch.empty((2, b, sk, h, e), **f32) if h > n else None
    chunk, nsplit = plan(b, sq, h, kv_len, causal, q_offset)
    part_q = torch.empty((nsplit, b, sq, h, e), **f32) if nsplit > 1 \
        else None
    lib = _build.library("flash_attention_bwd", _SIG)
    rc = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), _build.ptr(part_kv),
        _build.ptr(part_q),
        _build.DTYPE_CODES[q.dtype], b, sq, h, n, sk, e, kv_len, q_offset,
        int(causal), chunk, nsplit, _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention_bwd")
    launches.add()
    return dq, dk, dv


def plan(b: int, sq: int, h: int, kv_len: int, causal: bool,
         q_offset: int) -> Tuple[int, int]:
    """-> (chunk, nsplit) of ``flash_bwd_dq``: keys per split (a multiple
    of TILE) and the number of splits.  The key range a query tile may
    see (causal: up to the last query's position) is split only while the
    b·h·⌈sq/TILE⌉ blocks would leave the card under two blocks an SM, into
    at most one split per MIN_SPLIT_TILES key tiles (16 queries over 1601
    keys: 64 blocks become 320)."""
    kend = min(kv_len, q_offset + sq) if causal else kv_len
    tiles = max(1, -(-kend // TILE))
    base = b * h * -(-sq // TILE)
    nsplit = max(1, min(-(-2 * SMS // base), tiles // MIN_SPLIT_TILES))
    per = -(-tiles // nsplit)
    return per * TILE, -(-tiles // per)


def flops(q: torch.Tensor, kv_len: int, causal: bool, q_offset: int) -> int:
    """The five products over the visible pairs (S = Q·Kᵀ recomputed,
    dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K, dK = dSᵀ·Q), 2 flops a
    multiply-add."""
    from repro_torch.kernels.flash_attention import visible_pairs
    b, sq, h, e = q.shape
    return 10 * b * h * e * visible_pairs(sq, kv_len, causal, q_offset)


def bytes_moved(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor) -> int:
    """Each input read once (q, k, v, o, do, lse) and each gradient
    written once (dq, dk, dv)."""
    qb = q.numel() * q.element_size()
    kb = k.numel() * k.element_size()
    return 4 * qb + 4 * kb + lse.numel() * lse.element_size()
