"""K5: Mamba2 SSD intra-chunk term on Hopper — wrapper of
``csrc/ssd_chunk.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/mamba2_scan.py``.  For each
(batch, chunk, head) it computes the quadratic-within-chunk output
``y = (C Bᵀ ⊙ L)(dt·x)``, ``L[i,j] = exp(cs_i − cs_j)`` for ``i >= j``,
and the chunk's state contribution ``S = (B ⊙ exp(cs_last − cs))ᵀ(dt·x)``,
``cs = cumsum(dA)``; the inter-chunk recurrence stays in torch
(``models/ssm.py``).  B and C are read through their strides, so a view
broadcast from one group to every head (stride 0 on the head axis) costs
no copy.

:func:`plan` picks one of three kernels: ``ssd_decode`` for short chunks
(the engine's decode steps), ``ssd_chunk_mma`` for longer bf16 chunks
(tensor cores), ``ssd_chunk_fwd`` for f32 chunks and for widths that are
not multiples of 8 (CUDA cores).

Training: :class:`SsdChunkFn` saves the inputs, and its backward is K5's
backward kernel (``kernels/ssd_chunk_bwd.py``), which recomputes the
decays and the scores.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, L, P, require
from repro_torch.kernels.decode_attention import rows_aligned

MAX_Q = 256          # ssd_chunk_fwd's and ssd_chunk_mma's longest chunk
MAX_WIDTH = 64       # P and N
DECODE_MAX_Q = 4     # chunks up to this length take ssd_decode (PERF.md)
DECODE_LIMIT_Q = 32  # ssd_decode's longest chunk (one scan element a lane)
DECODE_SPLITS = (1, 2, 4, 8)  # ssd_decode's slices of S's rows
# ssd_decode's grid stays within one wave of this many blocks an SM (128
# threads of up to 128 registers each; it takes 96 in bf16, PERF.md)
DECODE_BLOCKS_PER_SM = 4
MMA_WARPS = 8        # ssd_chunk_mma's warps a block
# the card's limits the plan is checked against where no card is asked
# (the CPU tests): an H100 SXM's SMs and a block's most shared memory
H100 = (132, 232448)
KERNEL_IDS = {"ssd_chunk_fwd": 0, "ssd_decode": 1, "ssd_chunk_mma": 2}
_SIG = {"repro_ssd_chunk": [P] * 7 + [I] * 9 + [L] * 20 + [P]}

launches = _build.LaunchCounter()


class Plan(NamedTuple):
    """One launch: the kernel, splits (ssd_decode: slices of S's rows;
    ssd_chunk_mma: slices of P; else 1) and the grid (x, y, z)."""
    kernel: str
    splits: int
    grid: Tuple[int, int, int]


def plan(b: int, nc: int, Q: int, H: int, P: int, N: int,
         dtype: torch.dtype, kernel: Optional[str] = None,
         splits: Optional[int] = None,
         card: Tuple[int, int] = H100) -> Plan:
    """The launch of one call on a card of ``card`` = (SMs, a block's most
    shared memory in bytes); ``kernel`` and ``splits`` force a choice (a
    check of every kernel at every chunk length it takes).

    * Chunks of at most DECODE_MAX_Q tokens take ``ssd_decode``, whose
      bytes are almost all S: a block per (head, slice of S's rows, batch
      x chunk), in the most slices (of DECODE_SPLITS) that keep the grid
      within one wave (DECODE_BLOCKS_PER_SM).
    * Longer bf16 chunks take ``ssd_chunk_mma``, a block per (head, slice
      of P, batch x chunk) on the tensor cores, in the fewest slices that
      fit a block's shared memory and give 7/8 of the SMs a block: at
      zamba2's 64 heads two slices (128 blocks) beat one and four (each
      repeating the scores) at every Q measured (PERF.md).
    * f32 chunks, and any P or N not a multiple of 8 (the vector width of
      both kernels above), take the CUDA-core ``ssd_chunk_fwd``."""
    sms, smem = card
    vec = P % 8 == 0 and N % 8 == 0
    fits = mma_slices(Q, P, N, smem) if vec else []
    if kernel is None:
        kernel = ("ssd_decode" if vec and Q <= DECODE_MAX_Q else
                  "ssd_chunk_mma" if fits and dtype == torch.bfloat16 else
                  "ssd_chunk_fwd")
    require(kernel in KERNEL_IDS, f"ssd_chunk: no kernel {kernel!r}")
    if kernel == "ssd_chunk_mma":
        require(fits and dtype == torch.bfloat16,
                f"ssd_chunk_mma takes bf16 with N a multiple of 8 and P of "
                f"8, 16, 32 or 64 columns a slice, got {dtype}, P={P}, "
                f"N={N}")
        if splits is None:       # the fewest that give most SMs a block
            splits = next((s for s in fits
                           if H * b * nc * s >= sms * 7 // 8), fits[-1])
        require(splits in fits, f"ssd_chunk_mma: {splits} slices of P={P} "
                f"at Q={Q} (it takes {fits})")
        return Plan(kernel, splits, (H, splits, b * nc))
    if kernel == "ssd_chunk_fwd":
        return Plan(kernel, 1, (-(-Q // 64) + 1, H, b * nc))
    require(vec and Q <= DECODE_LIMIT_Q,
            f"ssd_decode takes Q <= {DECODE_LIMIT_Q} with P, N multiples "
            f"of 8, got Q={Q}, P={P}, N={N}")
    if splits is None:
        splits = max((s for s in DECODE_SPLITS
                      if s <= N and H * b * nc * s
                      <= DECODE_BLOCKS_PER_SM * sms), default=1)
    require(1 <= splits <= min(DECODE_SPLITS[-1], N),
            f"ssd_decode: {splits} slices of {N} state rows")
    rows = -(-N // splits)
    splits = -(-N // rows)              # no empty slice
    return Plan(kernel, splits, (H, splits, b * nc))


def mma_slices(Q: int, P: int, N: int, smem: int = H100[1]) -> List[int]:
    """The numbers of slices of P that ``ssd_chunk_mma`` takes at this
    shape: 8, 16, 32 or 64 columns a slice, within ``smem`` bytes of
    shared memory a block."""
    return [s for s in (1, 2, 4, 8) if P % s == 0 and P // s in (8, 16, 32, 64)
            and mma_smem(Q, N, P // s) <= smem]


def mma_smem(Q: int, N: int, PS: int) -> int:
    """Bytes of shared memory of an ssd_chunk_mma block: the total of
    ``MmaLayout`` in ``csrc/ssd_chunk.cu``, which trusts the plan to keep
    it within the card's limit."""
    Qp, NP = -(-Q // 16) * 16, MAX_WIDTH     # C and B padded to 64 columns
    ldh = -(-PS // 16) * 16 + 8
    return Qp * ((NP + 8) * 4 + (PS + 8) * 2 + ldh * 8 + 12) + 32 + 72


def mma_units(Q: int, N: int, PT: int) -> List[List[int]]:
    """The 16-row units each warp of an ``ssd_chunk_mma`` block takes, in
    order, dealt as the kernel's work loop deals them: units 0..ny-1 are
    y's row stripes, ny.. S's state-row stripes; PT is the block's 8-column
    tiles of P."""
    Qp = -(-Q // 16) * 16
    ny, ns, nk = Qp // 16, -(-N // 16), MAX_WIDTH // 16
    cost_s = (Qp // 8) * (2 + 3 * PT)
    heavy = sum((2 * r + 4) * 2 * (nk + 3 * PT) > cost_s for r in range(ny))
    out = []
    for warp in range(MMA_WARPS):
        units = []
        for rnd in itertools.count():
            k = rnd * MMA_WARPS + (MMA_WARPS - 1 - warp if rnd & 1 else warp)
            if k >= ny + ns:
                break
            units.append(ny - 1 - k if k < heavy else
                         ny + (k - heavy) if k < heavy + ns else
                         ny - 1 - (k - ns))
        out.append(units)
    return out


def work(p: Plan, b: int, nc: int, Q: int, H: int, N: int,
         P: int) -> Tuple[List[tuple], List[tuple]]:
    """(y rows, S rows) every block of ``p`` writes, as (b, chunk, head,
    row, first column, end column) tuples, by the index arithmetic of its
    kernel in ``csrc/ssd_chunk.cu`` (``ssd_chunk_mma``'s through
    :func:`mma_units`); the column ranges of each (b, chunk, head, row)
    must tile [0, P) once."""
    ys, ss = [], []
    gx, gy, gz = p.grid
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                bi, ci = divmod(bz, nc)
                if p.kernel == "ssd_decode":
                    split = by
                    ns = -(-N // p.splits)
                    n0 = min(N, split * ns)
                    ys += [(bi, ci, bx, i, 0, P) for i in
                           range(split, Q, p.splits)]
                    ss += [(bi, ci, bx, n, 0, P) for n in
                           range(n0, min(N, n0 + ns))]
                elif p.kernel == "ssd_chunk_mma":
                    ps = P // gy
                    cols = (by * ps, by * ps + ps)
                    ny = -(-Q // 16)
                    for units in mma_units(Q, N, ps // 8):
                        for u in units:
                            if u < ny:
                                ys += [(bi, ci, bx, i, *cols) for i in
                                       range(16 * u, min(Q, 16 * u + 16))]
                            else:
                                n0 = 16 * (u - ny)
                                ss += [(bi, ci, bx, n, *cols) for n in
                                       range(n0, min(N, n0 + 16))]
                else:
                    if bx == gx - 1:
                        ss += [(bi, ci, by, n, 0, P) for n in range(N)]
                    else:
                        ys += [(bi, ci, by, i, 0, P) for i in
                               range(64 * bx, min(Q, 64 * bx + 64))]
    return ys, ss


def _strides4(t: torch.Tensor):
    """Element strides of the (b, chunk, q, head) axes."""
    return t.stride()[:4]


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor,
              dA: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,nc,Q,H,P); dt/dA (b,nc,Q,H) f32; B/C (b,nc,Q,H,N) ->
    (y (b,nc,Q,H,P) f32, S (b,nc,H,N,P) f32).  x, B and C share one dtype
    (f32 or bf16) and are unit-stride on their last axis."""
    return run(x, dt, B, C, dA)


class SsdChunkFn(torch.autograd.Function):
    """K5 with a gradient, on the card (and on the meta device, where both
    directions give their result shapes: ``ops.meta_*``): the forward
    saves x, dt, B, C and dA; the backward is K5's backward kernel.
    Module globals are read at call time, so a wrapper set on
    :func:`ssd_chunk` or on ``ssd_chunk_bwd.ssd_chunk_bwd`` sees both
    directions.  dB and dC are per head: the backward of the caller's
    broadcast (an ``expand`` view, or ``repeat_interleave``) sums a
    group's heads."""

    @staticmethod
    def forward(ctx, x, dt, B, C, dA):
        if x.is_meta:
            from repro_torch.kernels import ops
            y, S = ops.meta_ssd_chunk(x, B)
        else:
            y, S = ssd_chunk(x, dt, B, C, dA)
        ctx.save_for_backward(x, dt, B, C, dA)
        return y, S

    @staticmethod
    def backward(ctx, dy, dS):
        from repro_torch.kernels import ops
        from repro_torch.kernels import ssd_chunk_bwd as bwd
        saved = ctx.saved_tensors
        with ops.observed("ssd_chunk_bwd", lambda: ops.ssd_bwd_cost(*saved)):
            if saved[0].is_meta:
                return ops.meta_ssd_chunk_bwd(*saved)
            return bwd.ssd_chunk_bwd(*saved, dy, dS)


def run(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        dA: torch.Tensor, kernel: Optional[str] = None,
        splits: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_chunk` with :func:`plan`'s launch, or with the kernel and
    splits given (checks of each kernel)."""
    _build.check_cuda("ssd_chunk", [x, dt, B, C, dA])
    require(x.dim() == 5 and B.dim() == 5 and C.shape == B.shape,
            f"ssd_chunk: bad shapes x {tuple(x.shape)}, B {tuple(B.shape)}, "
            f"C {tuple(C.shape)}")
    b, nc, Q, H, Pd = x.shape
    N = B.shape[-1]
    require(tuple(B.shape[:4]) == (b, nc, Q, H)
            and tuple(dt.shape) == (b, nc, Q, H) and dA.shape == dt.shape,
            f"ssd_chunk: x {tuple(x.shape)} vs B {tuple(B.shape)}, "
            f"dt {tuple(dt.shape)}, dA {tuple(dA.shape)}")
    require(1 <= Q <= MAX_Q, f"ssd_chunk: chunk length {Q} not in "
            f"[1, {MAX_Q}]")
    require(1 <= Pd <= MAX_WIDTH and 1 <= N <= MAX_WIDTH,
            f"ssd_chunk: head dim {Pd} / state {N} above {MAX_WIDTH}")
    require(b * nc >= 1 and H >= 1, "ssd_chunk: empty input")
    require(x.dtype in _build.DTYPE_CODES and B.dtype == x.dtype
            and C.dtype == x.dtype,
            f"ssd_chunk: dtypes x {x.dtype}, B {B.dtype}, C {C.dtype} "
            f"unsupported")
    require(dt.dtype == torch.float32 and dA.dtype == torch.float32,
            f"ssd_chunk: dt/dA must be f32, got {dt.dtype}/{dA.dtype}")
    require(x.stride(-1) == 1 and B.stride(-1) == 1 and C.stride(-1) == 1,
            "ssd_chunk: x, B, C must be unit-stride on their last axis")
    # the 16-byte loads of ssd_decode and ssd_chunk_mma need rows that
    # start on 16 bytes: the model's tensors do; any other view is copied
    x, B, C = (t if rows_aligned(t) else
               t.clone(memory_format=torch.contiguous_format)
               for t in (x, B, C))
    p = plan(b, nc, Q, H, Pd, N, x.dtype, kernel, splits, _card(x.device))
    y = torch.empty((b, nc, Q, H, Pd), dtype=torch.float32, device=x.device)
    S = torch.empty((b, nc, H, N, Pd), dtype=torch.float32, device=x.device)
    lib = _build.library("ssd_chunk", _SIG)
    rc = lib.repro_ssd_chunk(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        dA.data_ptr(), y.data_ptr(), S.data_ptr(),
        _build.DTYPE_CODES[x.dtype], KERNEL_IDS[p.kernel], p.splits,
        b, nc, Q, H, Pd, N,
        *_strides4(x), *_strides4(dt), *_strides4(B), *_strides4(C),
        *_strides4(dA), _build.stream_ptr(x))
    _build.check(lib, rc, f"ssd_chunk ({p.kernel})")
    launches.add()
    return y, S


@functools.lru_cache(maxsize=None)
def _card(device: torch.device) -> Tuple[int, int]:
    """(SMs, a block's most shared memory in bytes) of a CUDA device."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a view covers (a stride-0 axis, such
    as B broadcast over heads, is read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def bytes_moved(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, dA: torch.Tensor) -> int:
    """Each input's distinct elements read once; y and S written once."""
    b, nc, Q, H, Pd = x.shape
    N = B.shape[-1]
    return (sum(_distinct_bytes(t) for t in (x, dt, B, C, dA))
            + 4 * (b * nc * Q * H * Pd + b * nc * H * N * Pd))


def flops(x: torch.Tensor, B: torch.Tensor) -> List[tuple]:
    """-> [(flops, rate)]: flops (2 per multiply-add) and the peak rate
    that prices them.  The causal scores C·Bᵀ over the Q(Q+1)/2 visible
    pairs are a product of the inputs' own type with f32 sums, which the
    bf16 tensor cores compute exactly (torch.bfloat16).  The products
    with f32 factors, (scores ⊙ L)(dt·x) over the same pairs and the
    state (B ⊙ decay)ᵀ(dt·x), hold f32 accuracy fastest on the TF32
    tensor cores with the f32 operand split, hi·hi + hi·lo + lo·hi
    ("tf32x3", a third of the TF32 rate), as do f32 scores; in bf16, dt
    can go to the other side, so x (exact in TF32) is one operand and two
    products do ("tf32x2").  The elementwise exp and scaling are not
    counted."""
    b, nc, Q, H, Pd = x.shape
    N = B.shape[-1]
    pairs = Q * (Q + 1) // 2
    cells = 2 * b * nc * H
    bf16 = x.dtype == torch.bfloat16
    return [(cells * pairs * N, torch.bfloat16 if bf16 else "tf32x3"),
            (cells * (pairs * Pd + Q * N * Pd),
             "tf32x2" if bf16 else "tf32x3")]
