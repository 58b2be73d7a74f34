"""K2: GQA flash-attention forward on Hopper — wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py`` and adds
the two arguments prefill into a cache needs: ``q_offset`` (query ``i`` sits
at position ``q_offset + i``) and ``kv_len`` (keys at ``>= kv_len`` are
masked).  The causal mask is ``q_offset + qpos >= kpos``.  k/v may be any
view with a unit-stride head dim, such as the prefix ``cache[:, :L]``.
Window mode (``window`` > 0 with ``kv_positions``; the hybrid family's
ring cache) takes each key slot's position from ``kv_positions`` and masks
``kpos <= qpos - window`` too (``kernels/ref.py``); every slot tile is
then visited.

The input type picks the kernel (:func:`kernel_for`): bf16 runs
``flash_fwd_wgmma`` (tensor cores, TMA-fed K/V tiles, the GQA group packed
into 64-row tiles, the key range split across blocks by :func:`plan`), f32
runs ``flash_fwd`` (CUDA-core FMAs: wgmma has no full-f32 mode).

MLA mode (values narrower than keys, or an explicit ``scale``;
DeepSeek's ``repro/models/mla.py``), at the (q·k, v) widths of
``MLA_DIMS``: the absorbed prefill chunk over the latent cache (576, 512;
v a view of k's first 512 columns, n = 1, g = 128) and the naive forward
(192, 128, n = h, v apart).  :func:`mla_kernel_for` picks
``flash_mla_mma`` (the tensor cores) for the bf16 absorbed form and
``flash_mla`` (CUDA cores) for the rest; the key range is split by
:func:`mla_plan` and the splits folded by ``flash_mla_combine``.  Any
other pair of widths, or absorbed values apart from the keys, raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, L, P, require

HEAD_DIMS = (16, 64, 128)
M_TILE = 64             # rows of a wgmma tile: (query position, head)
KEY_TILE = 64           # keys per K/V tile
SMS = 132               # streaming multiprocessors of an H100 SXM
MIN_SPLIT_TILES = 2     # key tiles a split must have to be worth a combine
MLA_DIMS = ((576, 512), (192, 128))   # (q·k, v) widths of the MLA mode
MLA_ROWS = {"flash_mla": 32, "flash_mla_mma": 64}   # rows of a block
MLA_KEYS = 32           # keys of an MLA tile
_SIG = {"repro_flash_attention": [P] * 7 + [I] * 11 + [L] * 9 + [I] * 3
        + [P],
        "repro_flash_mla": [P] * 6 + [I] * 11 + [F] + [I] * 2 + [L] * 9
        + [I] + [P]}

launches = _build.LaunchCounter()
mla_launches = _build.LaunchCounter()     # the MLA mode's share of them


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (b, sq, h, e); k/v (b, sk, n, e) with h % n == 0 -> (b, sq, h, e)
    in q's dtype.  Window mode: ``window`` > 0 and ``kv_positions`` (sk,)
    int32, each slot's position.  MLA mode: v (b, sk, n, e_v) narrower
    than k, or a ``scale`` (else 1/sqrt(e)) -> (b, sq, h, e_v)."""
    if scale is not None or v.shape[-1:] != k.shape[-1:]:
        require(window == 0 and kv_positions is None,
                "flash_attention: the MLA mode has no window mode")
        return run_mla(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=kv_len, scale=scale)
    _build.check_cuda("flash_attention", [q, k, v] + (
        [] if kv_positions is None else [kv_positions]))
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
    require(sk >= 1, "flash_attention: no keys (sk = 0)")
    require(window >= 0 and (window > 0) == (kv_positions is not None),
            "flash_attention: window mode takes a window and kv_positions "
            "together")
    require(kv_positions is None or (
        kv_positions.shape == (sk,) and kv_positions.dtype == torch.int32
        and kv_positions.is_contiguous()),
            "flash_attention: kv_positions must be a contiguous (sk,) int32")
    out = torch.empty((b, sq, h, e), dtype=q.dtype, device=q.device)
    per_tile = chunk = nsplit = 0
    part_o = part_ml = out
    if kernel_for(q.dtype) == "flash_fwd_wgmma":
        q, k, v = (t if tma_ready(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        per_tile, _, chunk, nsplit = plan(b, sq, h, n, kv_len, causal,
                                          q_offset, ring=window > 0)
        if nsplit > 1:
            part_o = torch.empty((nsplit, b, sq, h, e), dtype=torch.float32,
                                 device=q.device)
            part_ml = torch.empty((nsplit, b, sq, h, 2),
                                  dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention", _SIG)
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_positions is None else kv_positions.data_ptr(),
        out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, sq, h, n, sk, e, kv_len, q_offset,
        int(causal), window, *tma_strides(q), *tma_strides(k),
        *tma_strides(v), per_tile, chunk, nsplit, _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention")
    launches.add()
    return out


def run_mla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, q_offset: int = 0,
            kv_len: Optional[int] = None, scale: Optional[float] = None,
            nsplit: Optional[int] = None) -> torch.Tensor:
    """The MLA mode of :func:`flash_attention` (the kernel of
    :func:`mla_kernel_for`); ``nsplit`` forces the number of key splits
    (else :func:`mla_plan`'s)."""
    _build.check_cuda("flash_attention", [q, k, v])
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4
            and v.shape[:3] == k.shape[:3],
            f"flash_attention: bad MLA shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, e = q.shape
    kb, sk, n, ke = k.shape
    ev = v.shape[-1]
    kv_len = sk if kv_len is None else int(kv_len)
    require(kb == b and ke == e and n >= 1 and h % n == 0 and sq >= 1,
            f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    require((e, ev) in MLA_DIMS, f"flash_attention: MLA widths (q·k {e}, "
            f"v {ev}) not in {MLA_DIMS}")
    require(0 <= kv_len <= sk and q_offset >= 0 and sk >= 1,
            f"flash_attention: kv_len {kv_len} / q_offset {q_offset} "
            f"out of range for sk={sk}")
    require(q.dtype in _build.DTYPE_CODES and k.dtype == q.dtype
            and v.dtype == q.dtype,
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
            f"unsupported")
    absorbed = (e, ev) == (576, 512)
    require(aliases_keys(k, v) or not absorbed,
            "flash_attention: the absorbed MLA form reads the values from "
            "the keys' first 512 columns; v must be that view of k")
    q, k, v = (t if rows_aligned(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    if absorbed:        # the K tile holds the values: keep v k's view
        v = k[..., :ev]
    kernel = mla_kernel_for(q.dtype, e)
    keys = min(kv_len, q_offset + sq) if causal else kv_len
    chunk, nsplit = mla_plan(b, n, sq * (h // n), keys, nsplit, kernel)
    out = torch.empty((b, sq, h, ev), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if nsplit > 1:
        part_o = torch.empty((nsplit, b * sq * h, ev), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((nsplit, b * sq * h, 2), dtype=torch.float32,
                              device=q.device)
    scale = e ** -0.5 if scale is None else float(scale)
    lib = _build.library("flash_attention", _SIG)
    rc = lib.repro_flash_mla(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _ptr(part_o), _ptr(part_ml), _build.DTYPE_CODES[q.dtype], b, sq, h,
        n, sk, e, ev, kv_len, q_offset, int(causal), scale, chunk, nsplit,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(kernel == "flash_mla_mma"), _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention (MLA mode)")
    launches.add()
    mla_launches.add()
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def rows_aligned(t: torch.Tensor) -> bool:
    """Every last-axis row starts on 16 bytes, as the kernels' 16-byte
    loads (vector loads, cp.async) need: the path's tensors and cache
    prefixes all do; any other view is copied first."""
    step = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(st % step == 0 for st in t.stride()[:-1]))


def aliases_keys(k: torch.Tensor, v: torch.Tensor) -> bool:
    """v is k's leading columns, as in the absorbed MLA form (the values
    are the latent ``ckv`` part of each cached ``[ckv | krope]`` row): the
    kernels read V from the K tile they already loaded."""
    return (v.data_ptr() == k.data_ptr() and v.stride() == k.stride()
            and v.shape[-1] <= k.shape[-1])


def mla_kernel_for(dtype: torch.dtype, e: int) -> str:
    """The MLA mode's kernel: the tensor cores for the bf16 absorbed form
    (q·k 576), the CUDA cores otherwise (f32 has no full-precision mma;
    the naive form runs once, without a cache)."""
    if dtype == torch.bfloat16 and e == 576:
        return "flash_mla_mma"
    return "flash_mla"


def mla_plan(b: int, n: int, rows: int, keys: int,
             nsplit: Optional[int] = None, kernel: str = "flash_mla"):
    """-> (chunk, nsplit) of the MLA mode: keys per split (a multiple of
    MLA_KEYS) and the number of splits.  A block of ``kernel`` takes
    MLA_ROWS[kernel] of the ``rows`` = g·sq (position, head) rows of a
    (b, kv head); the key range (``keys``, the most any row sees) is split
    only while the b·n·⌈rows/MLA_ROWS⌉ blocks leave the card under two a
    SM (one for flash_mla_mma, whose registers and shared memory hold one
    block an SM), down to one key tile a split (the single-token decode:
    4 blocks of 128 heads).  ``nsplit`` forces the split count (a check
    of the combine)."""
    mtiles = -(-rows // MLA_ROWS[kernel])
    tiles = max(1, -(-keys // MLA_KEYS))
    per_sm = 1 if kernel == "flash_mla_mma" else 2
    if nsplit is None:
        nsplit = max(1, min(-(-per_sm * SMS // (b * n * mtiles)), tiles))
    require(1 <= nsplit <= tiles, f"flash_attention: {nsplit} splits of "
            f"{tiles} key tiles")
    per = -(-tiles // nsplit)
    return per * MLA_KEYS, -(-tiles // per)


def mla_bytes_moved(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: int, *, causal: bool = True,
                    q_offset: int = 0) -> int:
    """q and the output once, and each key row some query sees once (its
    value columns too when v is a separate tensor)."""
    b, sq, h, e = q.shape
    n, ev = k.shape[2], v.shape[-1]
    rows = min(kv_len, q_offset + sq) if causal else kv_len
    width = e + (0 if aliases_keys(k, v) else ev)
    return ((q.numel() + b * sq * h * ev) * q.element_size()
            + b * rows * n * width * k.element_size())


def mla_flops(q: torch.Tensor, v: torch.Tensor, kv_len: int, causal: bool,
              q_offset: int) -> int:
    """q·k and p·v multiply-adds over the visible pairs (2 flops each)."""
    b, sq, h, e = q.shape
    return (2 * b * h * (e + v.shape[-1])
            * visible_pairs(sq, kv_len, causal, q_offset))


def kernel_for(dtype: torch.dtype) -> str:
    """The ``__global__`` that runs inputs of ``dtype``: a choice by type
    (wgmma has no full-f32 mode, and TF32 would break f32's 2e-5)."""
    if dtype == torch.bfloat16:
        return "flash_fwd_wgmma"
    if dtype == torch.float32:
        return "flash_fwd"
    raise ValueError(f"flash_attention: no kernel for {dtype}")


def plan(b: int, sq: int, h: int, n: int, kv_len: int, causal: bool,
         q_offset: int, ring: bool = False):
    """-> (per_tile, mtiles, chunk, nsplit) of ``flash_fwd_wgmma``: query
    positions per 64-row tile (the g = h/n heads of a kv head share it),
    tiles per (b, kv head), keys per split (a multiple of KEY_TILE) and
    the number of splits.  The key range is split only when the
    b·n·mtiles blocks would leave SMs idle, into at most one split per
    MIN_SPLIT_TILES key tiles, so each split's partial is worth its
    combine.  A causal call stops at the last key its queries can see,
    unless the keys carry their own positions (``ring``): then every slot
    below ``kv_len`` is visited."""
    g = h // n
    require(1 <= g <= M_TILE, f"flash_attention: {g} query heads per kv "
            f"head; the wgmma kernel packs at most {M_TILE}")
    per_tile = M_TILE // g
    mtiles = -(-sq // per_tile)
    kend = min(kv_len, q_offset + sq) if causal and not ring else kv_len
    key_tiles = -(-kend // KEY_TILE)
    base = b * n * mtiles
    nsplit = max(1, min(-(-SMS // base), key_tiles // MIN_SPLIT_TILES))
    chunk_tiles = max(1, -(-key_tiles // nsplit))
    nsplit = max(1, -(-key_tiles // chunk_tiles))
    return per_tile, mtiles, chunk_tiles * KEY_TILE, nsplit


def tma_ready(t: torch.Tensor) -> bool:
    """A TMA tensor map takes the view as it is: a 16-byte-aligned base
    and strides (of the axes longer than 1) that are multiples of 16
    bytes.  The path's tensors and cache prefixes all are; any other view
    is copied first."""
    return (t.data_ptr() % 16 == 0 and
            all(st % 8 == 0 for st, sz in zip(t.stride()[:3], t.shape[:3])
                if sz > 1))


def tma_strides(t: torch.Tensor):
    """Element strides of axes 0..2, an axis of length 1 given the stride
    it would have in a contiguous layout (the tensor map needs a valid
    stride even where the coordinate is always 0)."""
    out = list(t.stride()[:3])
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            out[i] = (out[i + 1] * t.shape[i + 1] if i < 2
                      else t.shape[3])
    return out


def _window_mask(sq: int, kv_len: int, causal: bool, q_offset: int,
                 kv_positions: torch.Tensor, window: int):
    from repro_torch.kernels.ref import visible
    return visible(torch.arange(sq) + q_offset, kv_positions[:kv_len].cpu(),
                   window, causal)


def visible_pairs(sq: int, kv_len: int, causal: bool, q_offset: int,
                  kv_positions: Optional[torch.Tensor] = None,
                  window: int = 0) -> int:
    """(query, key) pairs the mask leaves visible, per (batch, head); in
    window mode counted from the positions, on the host."""
    if window > 0:
        return int(_window_mask(sq, kv_len, causal, q_offset, kv_positions,
                                window).sum())
    if not causal:
        return sq * kv_len
    return sum(max(0, min(kv_len, q_offset + i + 1)) for i in range(sq))


def flops(q: torch.Tensor, kv_len: int, causal: bool, q_offset: int,
          **window_mode) -> int:
    """QK and PV multiply-adds over the visible pairs (2 flops each)."""
    b, sq, h, e = q.shape
    return 4 * b * h * e * visible_pairs(sq, kv_len, causal, q_offset,
                                         **window_mode)


def bytes_moved(q: torch.Tensor, k: torch.Tensor, kv_len: int, *,
                causal: bool = True, q_offset: int = 0,
                kv_positions: Optional[torch.Tensor] = None,
                window: int = 0) -> int:
    """q and the output once, and the K/V rows once: the first kv_len, or
    in window mode the slots some query sees, with their positions."""
    b, _, n, e = k.shape
    rows, extra = kv_len, 0
    if window > 0:
        rows = int(_window_mask(q.shape[1], kv_len, causal, q_offset,
                                kv_positions, window).any(0).sum())
        extra = 4 * kv_positions.numel()
    return (2 * q.numel() * q.element_size() + extra
            + 2 * b * rows * n * e * k.element_size())
