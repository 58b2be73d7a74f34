"""K2's backward on Hopper — wrapper of ``csrc/flash_attention_bwd.cu``.

The gradients of K2 (:func:`flash_attention.flash_attention`, no window or
MLA mode), two passes with no float atomics, so a gradient is the same in
every run.  The kernels are chosen by input type (:func:`kernel_for`):

* bf16: ``flash_bwd_prep`` (each query row's LSE, D = rowsum(dO ⊙ O) and
  key limit, in the packed (position, head) row order of the query
  tiles), ``flash_bwd_dkdv_wgmma`` (a block per (b, kv head, 64 keys),
  walking the query tiles of the g heads) and ``flash_bwd_dq_wgmma`` (a
  block per (b, kv head, 64-row query tile, key split)), every product
  on the tensor cores by ``wgmma`` with tiles by TMA; where a pass's
  blocks are few, :func:`wgmma_plan` splits its range and
  ``flash_bwd_sum`` adds the f32 partials in split order.
* f32: ``flash_bwd_delta``, ``flash_bwd_dkdv`` (a block per (b, query
  head, 64 keys)) and ``flash_bwd_dq`` (split by :func:`plan`), CUDA-core
  FMAs (``wgmma`` has no full-f32 mode); ``flash_bwd_sum`` adds the g
  query heads' dK/dV shares and the dQ splits in a fixed order.

The JAX package has no backward Pallas kernel: it differentiates
``repro/models/layers.py::mha`` with XLA; ``kernels/ref.py::
flash_attention_bwd_ref`` is the plain version, step by step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P, require

HEAD_DIMS = (16, 64, 128)
TILE = 64               # query rows and keys of a tile
SMS = 132               # streaming multiprocessors of an H100 SXM
MIN_SPLIT_TILES = 2     # tiles a split must have
ROW_INFO = 4            # f32-sized words of a query row's data (RowInfo)
_SIG = {"repro_flash_attention_bwd": [P] * 12 + [I] * 11 + [P],
        "repro_flash_attention_bwd_wgmma": [P] * 12 + [I] * 13 + [P]}

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
    q, k, v, o, do, lse = (_aligned(t.contiguous())
                           for t in (q, k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention_bwd", _SIG)
    if kernel_for(q.dtype)[0] == "flash_bwd_dkdv_wgmma":
        p = wgmma_plan(b, sq, h, n, sk, kv_len, causal, q_offset)
        info = torch.empty((b, n, p.mtiles * TILE, ROW_INFO), **f32)
        part_kv = torch.empty((2, p.kv_nsplit, b, sk, n, e), **f32) \
            if p.kv_nsplit > 1 else None
        part_q = torch.empty((p.nsplit, b, sq, h, e), **f32) \
            if p.nsplit > 1 else None
        rc = lib.repro_flash_attention_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), info.data_ptr(), _build.ptr(part_kv),
            _build.ptr(part_q), b, sq, h, n, sk, e, kv_len, q_offset,
            int(causal), p.per_tile, p.kv_nsplit, p.chunk, p.nsplit,
            _build.stream_ptr(q))
    else:
        delta = torch.empty((b, h, sq), **f32)
        part_kv = torch.empty((2, b, sk, h, e), **f32) if h > n else None
        chunk, nsplit = plan(b, sq, h, kv_len, causal, q_offset)
        part_q = torch.empty((nsplit, b, sq, h, e), **f32) if nsplit > 1 \
            else None
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), _build.ptr(part_kv),
            _build.ptr(part_q), b, sq, h, n, sk, e, kv_len, q_offset,
            int(causal), chunk, nsplit, _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention_bwd")
    launches.add()
    return dq, dk, dv


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its base is off the 16 bytes TMA needs."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_for(dtype: torch.dtype) -> Tuple[str, str]:
    """The dK/dV and dQ ``__global__``s that run inputs of ``dtype``: a
    choice by type, as the forward's (wgmma has no full-f32 mode, and
    TF32 would break f32's 2e-5)."""
    if dtype == torch.bfloat16:
        return "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"
    if dtype == torch.float32:
        return "flash_bwd_dkdv", "flash_bwd_dq"
    raise ValueError(f"flash_attention_bwd: no kernel for {dtype}")


class WgmmaPlan(NamedTuple):
    """The bf16 route's launch: ``per_tile`` query positions (of the g
    heads of a kv head) in a 64-row tile, ``mtiles`` such tiles per (b,
    kv head); the dK/dV pass's tiles split ``kv_nsplit`` ways; dQ's keys
    in ``nsplit`` ranges of ``chunk``."""
    per_tile: int
    mtiles: int
    kv_nsplit: int
    chunk: int
    nsplit: int


def wgmma_plan(b: int, sq: int, h: int, n: int, sk: int, kv_len: int,
               causal: bool, q_offset: int) -> WgmmaPlan:
    """The bf16 route's tiles and splits.  Each pass splits its range
    only while its blocks would leave the card under two an SM, into at
    most one split per MIN_SPLIT_TILES tiles: the dK/dV pass (a block per
    64 keys some query sees) its query tiles, the dQ pass (a block per
    query tile) its keys, as :func:`plan` does (16 queries over 1601 keys
    at g 8: 16 dQ blocks become 208)."""
    g = h // n
    require(1 <= g <= TILE, f"flash_attention_bwd: {g} query heads per kv "
            f"head; the wgmma kernels pack at most {TILE}")
    per_tile = TILE // g
    mtiles = -(-sq // per_tile)
    key_tiles = max(1, -(-kv_len // TILE))
    kv_nsplit = _splits(b * n * key_tiles, mtiles)
    kend = min(kv_len, q_offset + sq) if causal else kv_len
    tiles = max(1, -(-kend // TILE))
    nsplit = _splits(b * n * mtiles, tiles)
    return WgmmaPlan(per_tile, mtiles, kv_nsplit,
                     -(-tiles // nsplit) * TILE, nsplit)


def _splits(blocks: int, tiles: int) -> int:
    """Splits of a range of ``tiles`` over ``blocks`` blocks: up to two
    blocks an SM, no split under MIN_SPLIT_TILES tiles, none empty."""
    nsplit = max(1, min(-(-2 * SMS // blocks), tiles // MIN_SPLIT_TILES))
    per = -(-tiles // nsplit)
    return -(-tiles // per)


def plan(b: int, sq: int, h: int, kv_len: int, causal: bool,
         q_offset: int) -> Tuple[int, int]:
    """-> (chunk, nsplit) of the f32 route's ``flash_bwd_dq``: keys per
    split (a multiple of TILE) and the number of splits.  The key range a
    query tile may see (causal: up to the last query's position) is split
    only while the b·h·⌈sq/TILE⌉ blocks would leave the card under two
    blocks an SM, into at most one split per MIN_SPLIT_TILES key tiles (16
    queries over 1601 keys: 64 blocks become 320)."""
    kend = min(kv_len, q_offset + sq) if causal else kv_len
    tiles = max(1, -(-kend // TILE))
    nsplit = _splits(b * h * -(-sq // TILE), tiles)
    per = -(-tiles // nsplit)
    return per * TILE, nsplit


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
