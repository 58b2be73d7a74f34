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
runs ``flash_fwd`` (CUDA-core FMAs: wgmma has no full-f32 mode).  Both
take the (key, value) widths of ``HEAD_DIMS``: (16, 16), (64, 64), (128,
128), and ``NAIVE_MLA`` = (192, 128), DeepSeek's naive MLA form
(``repro/models/mla.py``'s forward without a cache: per-head K/V, n = h),
which also passes its ``scale`` (else 1/sqrt(key width)).

MLA mode (:func:`is_mla`: values narrower than keys, or an explicit
``scale``, at any widths but the naive pair) is the absorbed form,
``MLA_DIMS``: the prefill chunk over the latent cache (576, 512; v a view
of k's first 512 columns, n = 1, g = 128).  :func:`mla_kernel_for` picks
``flash_mla_mma`` (the tensor cores) in bf16 and ``flash_mla`` (CUDA
cores) in f32; the key range is split by :func:`mla_plan` and the splits
folded by ``flash_mla_combine``.  Any other pair of widths, or values
apart from the keys, raises.

Training: ``flash_attention(..., return_lse=True)`` also returns each
query row's natural-log LSE, f32 (b, h, sq), which the kernels write when
given a pointer (serving passes null); :class:`FlashAttentionFn` saves q,
k, v, the output and the LSE, and its backward is K2's backward kernel
(``kernels/flash_attention_bwd.py``), at every pair of ``HEAD_DIMS``, the
naive MLA form's included.  Window and MLA (absorbed) mode have no
backward (``kernels/ops.py`` raises if one is asked for on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention_bwd as _bwd
from repro_torch.kernels._build import F, I, L, P, require

HEAD_DIMS, NAIVE_MLA = _bwd.HEAD_DIMS, _bwd.NAIVE_MLA   # (key, value) widths
M_TILE = 64             # rows of a wgmma tile: (query position, head)
KEY_TILE = 64           # keys per K/V tile
SMS = 132               # streaming multiprocessors of an H100 SXM
MIN_SPLIT_TILES = 2     # key tiles a split must have to be worth a combine
MLA_DIMS = ((576, 512),)   # (q·k, v) widths of the MLA mode: absorbed
MLA_ROWS = {"flash_mla": 32, "flash_mla_mma": 64}   # rows of a block
MLA_KEYS = 32           # keys of an MLA tile
_SIG = {"repro_flash_attention": [P] * 8 + [I] * 12 + [F] + [L] * 9
        + [I] * 3 + [P],
        "repro_flash_mla": [P] * 6 + [I] * 11 + [F] + [I] * 2 + [L] * 9
        + [I] + [P]}

launches = _build.LaunchCounter()
mla_launches = _build.LaunchCounter()     # the MLA mode's share of them


def is_mla(k: torch.Tensor, v: torch.Tensor,
           scale: Optional[float]) -> bool:
    """A call of the MLA (absorbed) mode: values narrower than keys, or an
    explicit ``scale``, at any (key, value) widths but ``NAIVE_MLA``,
    which the generic route takes with its scale."""
    dims = (k.shape[-1], v.shape[-1])
    return dims != NAIVE_MLA and (scale is not None or dims[0] != dims[1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    window: int = 0,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """q (b, sq, h, e); k (b, sk, n, e), v (b, sk, n, e_v) with h % n == 0
    -> (b, sq, h, e_v) in q's dtype; (e, e_v) in ``HEAD_DIMS``, scores
    scaled by ``scale`` (else 1/sqrt(e); only the naive MLA pair takes
    one).  Window mode: ``window`` > 0 and ``kv_positions`` (sk,) int32,
    each slot's position.  MLA mode (:func:`is_mla`): the absorbed form.

    ``return_lse`` (neither mode) -> (out, lse): lse f32 (b, h, sq), each
    query row's log-sum-exp of its visible scaled scores, -inf for a row
    with no visible key (as ``ref.flash_attention_lse_ref``)."""
    mla = is_mla(k, v, scale)
    require(not (return_lse and (mla or window > 0
                                 or kv_positions is not None)),
            "flash_attention: the LSE output has no window or MLA mode")
    if mla:
        require(window == 0 and kv_positions is None,
                "flash_attention: the MLA mode has no window mode")
        return run_mla(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=kv_len, scale=scale)
    if not return_lse:
        return _run(q, k, v, causal, q_offset, kv_len, kv_positions,
                    window, scale, None)
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _run(q, k, v, causal, q_offset, kv_len, None, 0, scale,
                lse), lse


class FlashAttentionFn(torch.autograd.Function):
    """K2 with a gradient, on the card (and on the meta device, where both
    directions give their result shapes: ``ops.meta_*``): the forward
    saves q, k, v, the output and its LSE; the backward is K2's backward
    kernel, at every pair of ``HEAD_DIMS`` (``scale`` only with
    ``NAIVE_MLA``).  Module globals are read at call time, so a wrapper
    set on :func:`flash_attention` sees the training forward too."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int,
                kv_len: Optional[int], scale: Optional[float] = None):
        if q.is_meta:
            from repro_torch.kernels import ops
            out, lse = ops.meta_flash_attention(q, v, return_lse=True)
        else:
            out, lse = flash_attention(q, k, v, causal=causal,
                                       q_offset=q_offset, kv_len=kv_len,
                                       scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import ops
        q, k, v, out, lse = ctx.saved_tensors
        m = ctx.mask
        with ops.observed("flash_attention_bwd", lambda: ops.flash_bwd_cost(
                q, k, v, lse, m["causal"], m["q_offset"], m["kv_len"])):
            if q.is_meta:
                dq, dk, dv = ops.meta_flash_attention_bwd(q, k, v)
            else:
                dq, dk, dv = _bwd.flash_attention_bwd(q, k, v, out, dout,
                                                      lse, **m)
        return dq, dk, dv, None, None, None, None


def _run(q, k, v, causal, q_offset, kv_len, kv_positions, window, scale,
         lse):
    _build.check_cuda("flash_attention", [q, k, v] + (
        [] if kv_positions is None else [kv_positions]))
    require(q.dim() == 4 and k.dim() == 4 and v.shape[:3] == k.shape[:3],
            f"flash_attention: bad shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, h, e = q.shape
    kb, sk, n, ke = k.shape
    ev = v.shape[-1]
    kv_len = sk if kv_len is None else int(kv_len)
    require(kb == b and ke == e and h % n == 0,
            f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    require((e, ev) in HEAD_DIMS, f"flash_attention: (key, value) widths "
            f"({e}, {ev}) not in {HEAD_DIMS}")
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
    out = torch.empty((b, sq, h, ev), dtype=q.dtype, device=q.device)
    per_tile = chunk = nsplit = 0
    part_o = part_ml = out
    if kernel_for(q.dtype) == "flash_fwd_wgmma":
        q, k, v = (t if tma_ready(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        per_tile, _, chunk, nsplit = plan(b, sq, h, n, kv_len, causal,
                                          q_offset, ring=window > 0)
        if nsplit > 1:
            part_o = torch.empty((nsplit, b, sq, h, ev), dtype=torch.float32,
                                 device=q.device)
            part_ml = torch.empty((nsplit, b, sq, h, 2),
                                  dtype=torch.float32, device=q.device)
    scale = e ** -0.5 if scale is None else float(scale)
    lib = _build.library("flash_attention", _SIG)
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_positions is None else kv_positions.data_ptr(),
        out.data_ptr(), _build.ptr(lse),
        part_o.data_ptr(), part_ml.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, sq, h, n, sk, e, ev, kv_len,
        q_offset, int(causal), window, scale, *tma_strides(q),
        *tma_strides(k), *tma_strides(v), per_tile, chunk, nsplit,
        _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention")
    launches.add()
    return out


def run_mla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, q_offset: int = 0,
            kv_len: Optional[int] = None, scale: Optional[float] = None,
            nsplit: Optional[int] = None) -> torch.Tensor:
    """The MLA mode of :func:`flash_attention`, the absorbed form (the
    kernel of :func:`mla_kernel_for`); ``nsplit`` forces the number of key
    splits (else :func:`mla_plan`'s)."""
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
    require(aliases_keys(k, v),
            "flash_attention: the absorbed MLA form reads the values from "
            "the keys' first 512 columns; v must be that view of k")
    q, k = (t if rows_aligned(t) else
            t.clone(memory_format=torch.contiguous_format) for t in (q, k))
    v = k[..., :ev]     # the K tile holds the values: keep v k's view
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
        _build.ptr(part_o), _build.ptr(part_ml), _build.DTYPE_CODES[q.dtype], b, sq, h,
        n, sk, e, ev, kv_len, q_offset, int(causal), scale, chunk, nsplit,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(kernel == "flash_mla_mma"), _build.stream_ptr(q))
    _build.check(lib, rc, "flash_attention (MLA mode)")
    launches.add()
    mla_launches.add()
    return out


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
    """The MLA mode's kernel, the absorbed form's (q·k ``e`` = 576): the
    tensor cores in bf16, the CUDA cores in f32 (no full-precision mma).
    Other widths are not MLA mode (the naive form runs on the generic
    route) and raise."""
    require(e == MLA_DIMS[0][0], f"flash_attention: q·k width {e} is not "
            f"the absorbed MLA form's {MLA_DIMS[0][0]}")
    return "flash_mla_mma" if dtype == torch.bfloat16 else "flash_mla"


def mla_plan(b: int, n: int, rows: int, keys: int,
             nsplit: Optional[int] = None, kernel: str = "flash_mla"):
    """-> (chunk, nsplit) of the MLA mode: keys per split (a multiple of
    MLA_KEYS) and the number of splits.  A block of ``kernel`` takes
    MLA_ROWS[kernel] of the ``rows`` = g·sq (position, head) rows of a
    (b, kv head); the key range (``keys``, the most any row sees) is split
    only while the b·n·⌈rows/MLA_ROWS⌉ blocks leave the card under two a
    SM (one for flash_mla_mma, whose registers and shared memory hold one
    block an SM), down to one key tile a split (the single-token decode:
    4 blocks of 128 heads).  The plan knows no widths.  ``nsplit`` forces the split count (a check
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
    """q and the output once, and each latent key row some query sees
    once (the values are its first columns)."""
    b, sq, h, e = q.shape
    n, ev = k.shape[2], v.shape[-1]
    rows = min(kv_len, q_offset + sq) if causal else kv_len
    return ((q.numel() + b * sq * h * ev) * q.element_size()
            + b * rows * n * e * k.element_size())


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
          ev: Optional[int] = None, **window_mode) -> int:
    """QK (over q's width) and PV (over the value width ``ev``, else q's)
    multiply-adds over the visible pairs (2 flops each)."""
    b, sq, h, e = q.shape
    ev = e if ev is None else ev
    return 2 * b * h * (e + ev) * visible_pairs(sq, kv_len, causal,
                                                q_offset, **window_mode)


def bytes_moved(q: torch.Tensor, k: torch.Tensor, kv_len: int, *,
                causal: bool = True, q_offset: int = 0,
                kv_positions: Optional[torch.Tensor] = None,
                window: int = 0, ev: Optional[int] = None) -> int:
    """q and the output (``ev`` wide, else q's width) once, and the K/V
    rows once: the first kv_len, or in window mode the slots some query
    sees, with their positions."""
    b, sq, h, e = q.shape
    n = k.shape[2]
    ev = e if ev is None else ev
    rows, extra = kv_len, 0
    if window > 0:
        rows = int(_window_mask(sq, kv_len, causal, q_offset,
                                kv_positions, window).any(0).sum())
        extra = 4 * kv_positions.numel()
    return ((q.numel() + b * sq * h * ev) * q.element_size() + extra
            + b * rows * n * (e + ev) * k.element_size())
