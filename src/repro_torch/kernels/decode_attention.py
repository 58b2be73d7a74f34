"""K1: GQA flash-decode on Hopper — wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``.  One
new query token per sequence attends over the first ``lengths[b]``
positions of a ``(b, S, n, e)`` cache, read in place through its strides
(a prefix view ``cache[:, :L]`` costs nothing).  A row of length 0 outputs
0, as the reference ``mha`` does.  Window mode (``window`` > 0, the hybrid
family's ring cache) also masks each slot by its position: visible iff
``q_pos[b] - window < kv_positions[j] <= q_pos[b]`` (``kernels/ref.py``).

One launch of ``decode_attn`` per call, allocating nothing but the output:
a block per (b, kv head or query head, key split), every warp on its own
key rows; when :func:`split_plan` splits a row, its splits run as one
thread-block cluster and merge through distributed shared memory.

MLA mode (values narrower than keys, or an explicit ``scale``;
DeepSeek's absorbed decode, ``repro/models/mla.py``) at (q·k, v) = (576,
512): the 128 query heads over one latent row per position (n = 1; v
must be the view of k's first 512 columns, which the kernel reads from
the K tile), in bf16 on the tensor cores (``decode_mla_mma``, K2's
absorbed loop with one query a row), in f32 on the CUDA cores
(``decode_mla``; ``flash_attention.mla_kernel_for``), the key range split
by ``flash_attention.mla_plan`` and folded by ``decode_mla_combine``.
Any other pair of widths, or values apart from the keys, raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, L, P, require
from repro_torch.kernels.flash_attention import (aliases_keys,
                                                 mla_kernel_for, mla_plan,
                                                 rows_aligned)

HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 16          # query heads per kv head (the largest template)
MAX_SPLIT = 8           # blocks of one cluster (the portable limit)
SHORT_ROW = 64          # keys up to which a block takes one query head
SPLIT_STEPS = 2         # load steps a split block must have at least
TARGET_BLOCKS = 264     # two blocks per SM of an H100
MLA_DIMS = ((576, 512),)  # (q·k, v) widths of the MLA mode
_SIG = {"repro_decode_attention": [P] * 7 + [I] * 11 + [L] * 6 + [P],
        "repro_decode_mla": [P] * 6 + [I] * 7 + [F] + [I] * 2 + [L] * 5
        + [I] + [P]}

launches = _build.LaunchCounter()
mla_launches = _build.LaunchCounter()     # the MLA mode's share of them


def split_plan(b: int, h: int, n: int, S: int, e: int, itemsize: int = 2,
               nsplit: Optional[int] = None):
    """-> (chunk, nsplit, heads, warps) of ``decode_attn``: keys per split
    block, splits per row (one cluster), query heads per block and warps
    per block.

    The serving paths' calls are latency-bound (at most 923 keys), so the
    plan trades the reuse of each K row by the g heads of a block against
    the length of a block's chain of loads:

    * a short row (at most SHORT_ROW keys, every call of the RAG path)
      takes a block per (b, query head) of 4 warps, unsplit: each block
      scores one head, and the g blocks of a kv head read its rows from
      L2;
    * a longer row keeps the g heads together (each K row serves all g),
      with 8 warps where g = 1 (the zamba2 engine) and 4 otherwise (at g
      >= 2 eight warps left one block per SM, and measured slower), and
      is split only when the b·n blocks leave SMs idle, into at most
      MAX_SPLIT splits of at least SPLIT_STEPS load steps each: a cluster
      costs about as much as one more step.

    ``nsplit`` forces the split count (a check of every cluster size)."""
    g = h // n
    rows = 32 // (e * itemsize // 16)          # rows per warp per step
    if nsplit is None and S <= SHORT_ROW and b * h <= TARGET_BLOCKS:
        return S, 1, 1, 4
    warps = 8 if g == 1 else 4
    per_step = 4 if g <= 4 else 2               # rows per lane group
    if nsplit is None:
        want = -(-TARGET_BLOCKS // (b * n))
        step = warps * rows * per_step          # keys of one load step
        nsplit = max(1, min(MAX_SPLIT, want, S // (SPLIT_STEPS * step)))
    chunk = -(-S // nsplit)
    return chunk, -(-S // chunk), g, warps


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     kv_positions: Optional[torch.Tensor] = None,
                     q_pos: Optional[torch.Tensor] = None,
                     window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (b, h, e); k/v_cache (b, S, n, e); lengths (b,) int32 -> (b, h, e)
    in q's dtype.  Window mode: ``window`` > 0, ``q_pos`` (b,) int32 and
    ``kv_positions`` (S,) int32.  MLA mode: v_cache (b, S, n, e_v)
    narrower than k_cache, or a ``scale`` (else 1/sqrt(e)) -> (b, h,
    e_v)."""
    if scale is not None or v_cache.shape[-1:] != k_cache.shape[-1:]:
        require(window == 0 and kv_positions is None and q_pos is None,
                "decode_attention: the MLA mode has no window mode")
        return run_mla(q, k_cache, v_cache, lengths, scale=scale)
    return run(q, k_cache, v_cache, lengths, kv_positions=kv_positions,
               q_pos=q_pos, window=window)


def run(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
        lengths: torch.Tensor, nsplit: Optional[int] = None, *,
        kv_positions: Optional[torch.Tensor] = None,
        q_pos: Optional[torch.Tensor] = None,
        window: int = 0) -> torch.Tensor:
    """:func:`decode_attention` with the plan of :func:`split_plan`, or
    with ``nsplit`` splits of ``ceil(S / nsplit)`` keys (a check of every
    cluster size)."""
    _build.check_cuda("decode_attention", [q, k_cache, v_cache, lengths]
                      + [t for t in (kv_positions, q_pos) if t is not None])
    require(q.dim() == 3 and k_cache.dim() == 4
            and v_cache.shape == k_cache.shape,
            f"decode_attention: bad shapes q {tuple(q.shape)}, "
            f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    b, h, e = q.shape
    kb, S, n, ke = k_cache.shape
    require(kb == b and ke == e and S >= 1,
            f"decode_attention: q {tuple(q.shape)} vs cache "
            f"{tuple(k_cache.shape)}")
    require(h % n == 0 and h // n <= MAX_GROUP,
            f"decode_attention: {h} heads over {n} kv heads unsupported")
    require(e in HEAD_DIMS, f"decode_attention: head dim {e} not in "
            f"{HEAD_DIMS}")
    require(q.dtype in _build.DTYPE_CODES and k_cache.dtype == q.dtype
            and v_cache.dtype == q.dtype,
            f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
            f"{v_cache.dtype} unsupported")
    require(q.is_contiguous() and k_cache.stride(-1) == 1
            and v_cache.stride(-1) == 1,
            "decode_attention: q must be contiguous and k/v unit-stride "
            "on the head dim")
    require(lengths.shape == (b,) and lengths.dtype == torch.int32
            and lengths.is_contiguous(),
            "decode_attention: lengths must be a contiguous (b,) int32")
    require(nsplit is None or 1 <= nsplit <= min(MAX_SPLIT, S),
            f"decode_attention: {nsplit} splits of {S} keys")
    require(window >= 0 and (window > 0) == (kv_positions is not None)
            == (q_pos is not None),
            "decode_attention: window mode takes a window, kv_positions "
            "and q_pos together")
    if window > 0:
        require(q_pos.shape == (b,) and q_pos.dtype == torch.int32
                and q_pos.is_contiguous(),
                "decode_attention: window mode needs a contiguous (b,) "
                "int32 q_pos")
        require(kv_positions.shape == (S,)
                and kv_positions.dtype == torch.int32
                and kv_positions.is_contiguous(),
                "decode_attention: kv_positions must be a contiguous (S,) "
                "int32")
    chunk, nsplit, heads, warps = split_plan(b, h, n, S, e,
                                             q.element_size(), nsplit)
    q, k_cache, v_cache = (t if rows_aligned(t) else
                           t.clone(memory_format=torch.contiguous_format)
                           for t in (q, k_cache, v_cache))
    out = torch.empty_like(q)
    lib = _build.library("decode_attention", _SIG)
    rc = lib.repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), _ptr(kv_positions), _ptr(q_pos), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, h, n, S, e, chunk, nsplit, heads,
        warps, window, *k_cache.stride()[:3], *v_cache.stride()[:3],
        _build.stream_ptr(q))
    _build.check(lib, rc, "decode_attention")
    launches.add()
    return out


def run_mla(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            lengths: torch.Tensor, *, scale: Optional[float] = None,
            nsplit: Optional[int] = None) -> torch.Tensor:
    """The MLA mode of :func:`decode_attention`; ``nsplit`` forces the
    number of key splits (else ``mla_plan``'s)."""
    _build.check_cuda("decode_attention", [q, k_cache, v_cache, lengths])
    require(q.dim() == 3 and k_cache.dim() == 4 and v_cache.dim() == 4
            and v_cache.shape[:3] == k_cache.shape[:3],
            f"decode_attention: bad MLA shapes q {tuple(q.shape)}, "
            f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    b, h, e = q.shape
    kb, S, n, ke = k_cache.shape
    ev = v_cache.shape[-1]
    require(kb == b and ke == e and S >= 1 and n >= 1 and h % n == 0,
            f"decode_attention: q {tuple(q.shape)} vs cache "
            f"{tuple(k_cache.shape)}")
    require((e, ev) in MLA_DIMS, f"decode_attention: MLA widths (q·k {e}, "
            f"v {ev}) not in {MLA_DIMS}")
    require(aliases_keys(k_cache, v_cache),
            "decode_attention: the MLA mode reads the values from the keys' "
            "first columns; v_cache must be that view of k_cache")
    require(q.dtype in _build.DTYPE_CODES and k_cache.dtype == q.dtype
            and v_cache.dtype == q.dtype,
            f"decode_attention: dtypes {q.dtype}/{k_cache.dtype}/"
            f"{v_cache.dtype} unsupported")
    require(lengths.shape == (b,) and lengths.dtype == torch.int32
            and lengths.is_contiguous(),
            "decode_attention: lengths must be a contiguous (b,) int32")
    q, k_cache = (t if rows_aligned(t) else
                  t.clone(memory_format=torch.contiguous_format)
                  for t in (q, k_cache))
    kernel = mla_kernel_for(q.dtype, e)
    chunk, nsplit = mla_plan(b, n, h // n, S, nsplit, kernel)
    out = torch.empty((b, h, ev), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if nsplit > 1:
        part_o = torch.empty((nsplit, b * h, ev), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((nsplit, b * h, 2), dtype=torch.float32,
                              device=q.device)
    scale = e ** -0.5 if scale is None else float(scale)
    lib = _build.library("decode_attention", _SIG)
    rc = lib.repro_decode_mla(
        q.data_ptr(), k_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _ptr(part_o), _ptr(part_ml),
        _build.DTYPE_CODES[q.dtype], b, h, n, S, e, ev, scale, chunk,
        nsplit, q.stride(0), q.stride(1), *k_cache.stride()[:3],
        int(kernel == "flash_mla_mma"), _build.stream_ptr(q))
    _build.check(lib, rc, "decode_attention (MLA mode)")
    launches.add()
    mla_launches.add()
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def visible_keys(lengths: torch.Tensor, S: int, *,
                 kv_positions: Optional[torch.Tensor] = None,
                 q_pos: Optional[torch.Tensor] = None,
                 window: int = 0) -> int:
    """Cache rows the query of each row sees, summed over the batch: the
    first ``lengths[b]``, and in window mode only those inside the window
    (counted from the inputs, on the host)."""
    if window <= 0:
        return int(lengths.clamp(0, S).sum())
    from repro_torch.kernels.ref import valid_slots, visible
    mask = visible(q_pos.cpu()[:, None], kv_positions.cpu(), window)[:, 0]
    return int((mask & valid_slots(S, lengths.cpu(), "cpu")).sum())


def bytes_moved(q: torch.Tensor, k_cache: torch.Tensor,
                lengths: torch.Tensor, **window_mode) -> int:
    """Least bytes one call must move: q, the visible K and V rows, the
    lengths (and in window mode the positions) and the output, each
    once."""
    S, n, e = k_cache.shape[1:]
    rows = visible_keys(lengths, S, **window_mode)
    extra = 0
    if window_mode.get("window", 0) > 0:
        extra = 4 * q.shape[0] + 4 * window_mode["kv_positions"].numel()
    return (2 * q.numel() * q.element_size() + lengths.numel() * 4 + extra
            + 2 * rows * n * e * k_cache.element_size())


def flops(q: torch.Tensor, lengths: torch.Tensor, S: int,
          **window_mode) -> int:
    """QK and PV multiply-adds over the visible keys (2 flops each)."""
    h, e = q.shape[1], q.shape[2]
    return 4 * h * e * visible_keys(lengths, S, **window_mode)


def mla_bytes_moved(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, lengths: torch.Tensor) -> int:
    """q, the output and the lengths once, and each visible latent row
    once (the values are its first columns)."""
    b, h, e = q.shape
    rows = visible_keys(lengths, k_cache.shape[1])
    return ((q.numel() + b * h * v_cache.shape[-1]) * q.element_size()
            + 4 * b + rows * k_cache.shape[2] * e * k_cache.element_size())


def mla_flops(q: torch.Tensor, v_cache: torch.Tensor,
              lengths: torch.Tensor, S: int) -> int:
    """q·k and p·v multiply-adds over the visible keys (2 flops each)."""
    h, e = q.shape[1], q.shape[2]
    return 2 * h * (e + v_cache.shape[-1]) * visible_keys(lengths, S)
