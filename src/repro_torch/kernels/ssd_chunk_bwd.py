"""K5's backward on Hopper — wrapper of ``csrc/ssd_chunk_bwd.cu``.

The gradients of K5 (:func:`ssd_chunk.ssd_chunk`, the Mamba2 SSD
intra-chunk term and chunk states) with respect to x, dt, B, C and dA,
given the cotangents dy and dS.  No float atomics, so a gradient is the
same in every run.  Each 64-row tile of a (batch, chunk, head) cell has a
block in two roles: a key tile writes dx, ddt and dB and G's column sums,
a query tile dC and G's row sums; ``ssd_bwd_finish`` (a block per (head,
batch x chunk)) then does the f64 scans into ddA.  :func:`plan` picks the
route by type and widths:

* ``ssd_bwd_mma`` (bf16 with P and N multiples of 8): ``ssd_bwd_keys_mma``
  then ``ssd_bwd_queries_mma``, one kernel a role, 4 warps a block, on
  the tensor cores: the scores on the bf16 ones, the products with an f32
  operand (dy, dS, and the recomputed M and dM ⊙ L) on the TF32 ones with
  each f32 operand split into TF32 halves (three products for Mᵀ·dy; two
  where the other operand is bf16, exact in TF32, which dM = (dy·xᵀ) ⊙
  dt_j is), 16 x 16 units above the diagonal skipped, the other role's
  tiles by cp.async in two stages.
* ``ssd_bwd_tiles`` (f32, and other widths): one kernel for both roles, in
  f32 on the CUDA cores (the port's first version).

The derivation and the designs are in the source's header.

B and C come per head (a stride-0 view broadcast from one group is read
in place) and dB, dC leave per head, in the inputs' dtype: autograd's
backward of the model's broadcast sums a group's heads
(``models/ssm.py``'s ``_heads``).

The JAX package has no backward Pallas kernel: it differentiates
``repro/models/ssm.py::mamba2_forward`` with XLA;
``kernels/ref.py::ssd_chunk_bwd_ref`` is the plain version, step by step.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, L, P, require
from repro_torch.kernels.decode_attention import rows_aligned
from repro_torch.kernels.ssd_chunk import (H100, MAX_Q, MAX_WIDTH, _card,
                                           _distinct_bytes)

TILE = 64            # rows and keys of a tile; MAX_WIDTH pads P and N to it
UNIT = 16            # rows of a warp's stripe in the mma route
MMA_WARPS = TILE // UNIT
PARTS = 3            # a cell's row sums, column sums and w terms (f32)
# ssd_bwd_tiles' shared memory: the f64 scan and f32 cs (MAX_Q each) and
# six 64 x 65 f32 tiles (kSmem in csrc/ssd_chunk_bwd.cu)
SMEM = MAX_Q * 8 + MAX_Q * 4 + 6 * TILE * (TILE + 1) * 4
# the mma route's row strides: bf16 tiles (C, B, x) and f32 ones (dy and
# its TF32 halves), kLdK and kLdF in csrc/ssd_chunk_bwd.cu
LD_BF16, LD_F32 = TILE + 8, TILE + 4
KERNEL_IDS = {"ssd_bwd_tiles": 0, "ssd_bwd_mma": 1}
ROLES = ("keys", "queries")
_SIG = {"repro_ssd_chunk_bwd": [P] * 13 + [I] * 8 + [L] * 20 + [P]}

launches = _build.LaunchCounter()


class Plan(NamedTuple):
    """One call's launches: the role tiles (heads, batch x chunk, 2 x
    64-row tiles; ``ssd_bwd_tiles`` runs them as one grid, the mma route
    as two grids of the tiles, keys then queries), a block's most shared
    memory, ``ssd_bwd_finish``'s grid, and the route (a key of
    ``KERNEL_IDS``: "ssd_bwd_mma" launches ``ssd_bwd_keys_mma`` and
    ``ssd_bwd_queries_mma``, "ssd_bwd_tiles" ``ssd_bwd_tiles``)."""
    tiles: Tuple[int, int, int]
    smem: int
    finish: Tuple[int, int]
    kernel: str


def plan(b: int, nc: int, Q: int, H: int, P: int, N: int,
         dtype: torch.dtype, kernel: Optional[str] = None,
         card: Tuple[int, int] = H100) -> Plan:
    """The launch of one call on a card of ``card`` = (SMs, a block's
    most shared memory in bytes); ``kernel`` forces a route (a check of
    each route at every shape it takes).  bf16 with P and N multiples of
    8 takes ``ssd_bwd_mma`` (tensor cores); f32, and other widths, take
    ``ssd_bwd_tiles`` (CUDA cores, every tile f32 in shared memory, the
    same shared memory at every Q)."""
    require(dtype in _build.DTYPE_CODES, f"ssd_chunk_bwd: dtype {dtype} "
            f"unsupported")
    require(1 <= Q <= MAX_Q, f"ssd_chunk_bwd: chunk length {Q} not in "
            f"[1, {MAX_Q}]")
    require(1 <= P <= MAX_WIDTH and 1 <= N <= MAX_WIDTH,
            f"ssd_chunk_bwd: head dim {P} / state {N} not in "
            f"[1, {MAX_WIDTH}]")
    require(b * nc >= 1 and H >= 1, "ssd_chunk_bwd: empty input")
    mma = dtype == torch.bfloat16 and P % 8 == 0 and N % 8 == 0
    if kernel is None:
        kernel = "ssd_bwd_mma" if mma else "ssd_bwd_tiles"
    require(kernel in KERNEL_IDS, f"ssd_chunk_bwd: no kernel {kernel!r}")
    if kernel == "ssd_bwd_mma":
        require(mma, f"ssd_bwd_mma takes bf16 with P and N multiples of 8, "
                f"got {dtype}, P={P}, N={N}")
        smem = max(mma_smem(Q, role) for role in ROLES)
    else:
        smem = SMEM
    require(smem <= card[1], f"ssd_chunk_bwd: {smem} bytes of shared "
            f"memory a block, the card allows {card[1]}")
    return Plan((H, b * nc, 2 * -(-Q // TILE)), smem, (H, b * nc), kernel)


def mma_smem(Q: int, role: str) -> int:
    """Bytes of shared memory of an ``ssd_bwd_keys_mma`` (``role`` "keys")
    or ``ssd_bwd_queries_mma`` ("queries") block: the total of
    ``BwdLayout`` in ``csrc/ssd_chunk_bwd.cu``, which the launch trusts.
    Keys: two stages of C_i (bf16) and dy_i (f32, split in place into its
    TF32 lo half) and a buffer of dy_i's TF32 hi half; queries: two stages
    of B_j and x_j (bf16); both cs and dt for every row of the padded
    chunk, the scan's four warp totals and cs's last row (f64)."""
    require(role in ROLES, f"ssd_chunk_bwd: no role {role!r}")
    Qp = -(-Q // TILE) * TILE
    tile16, tile32 = TILE * LD_BF16 * 2, TILE * LD_F32 * 4
    if role == "keys":
        staged, hi = tile16 + tile32, tile32
    else:
        staged, hi = 2 * tile16, 0
    return 2 * staged + hi + 2 * Qp * 4 + 5 * 8


def mma_units(Q: int, role: str) -> Dict[Tuple[int, int], List[tuple]]:
    """(tile, warp) -> the 16 x 16 units (I, J) (query rows 16I.., keys
    16J..) its warp computes, in order, by the loops of
    ``ssd_bwd_keys_mma`` (``role`` "keys": the warp's key stripe J = 4 tile
    + warp against the query tiles from its own to the last) or
    ``ssd_bwd_queries_mma`` ("queries": the query stripe I against the key
    tiles from the first to its own); a unit wholly above the diagonal (I
    < J) or past the chunk is skipped."""
    require(role in ROLES, f"ssd_chunk_bwd: no role {role!r}")
    nT, nU = -(-Q // TILE), -(-Q // UNIT)
    out = {}
    for tile, warp in itertools.product(range(nT), range(MMA_WARPS)):
        own = MMA_WARPS * tile + warp
        walk = range(tile, nT) if role == "keys" else range(tile + 1)
        units = []
        for other in walk:
            for u in range(MMA_WARPS):
                I, J = ((MMA_WARPS * other + u, own) if role == "keys" else
                        (own, MMA_WARPS * other + u))
                if own < nU and I >= J and I < nU and J < nU:
                    units.append((I, J))
        out[(tile, warp)] = units
    return out


def work(p: Plan, b: int, nc: int, Q: int, H: int) -> Dict[str, List[tuple]]:
    """The gradient rows every block of ``p`` writes, as (b, chunk, head,
    row) tuples by role: "keys" (dx, ddt, dB and G's column sums and w
    terms of keys j) and "queries" (dC and G's row sums of queries i), by
    the index arithmetic of the route's kernels (the mma route's warps
    write their 16-row stripes; ``ssd_bwd_tiles``' threads their 64-row
    tiles, key roles at even blockIdx.z)."""
    rows = {role: [] for role in ROLES}
    gx, gy, gz = p.tiles
    nT = gz // 2
    for h, bz, z in itertools.product(range(gx), range(gy), range(gz)):
        bi, ci = divmod(bz, nc)
        if p.kernel == "ssd_bwd_mma":
            role = ROLES[z // nT]
            # the key grid takes tile z; the query grid's z runs from the
            # last tile down
            tile = z if role == "keys" else nT - 1 - (z - nT)
            for warp in range(MMA_WARPS):
                r0 = tile * TILE + UNIT * warp
                rows[role] += [(bi, ci, h, r) for r in
                               range(r0, min(Q, r0 + UNIT))]
        else:
            role = "keys" if z % 2 == 0 else "queries"
            tile = z // 2 if role == "keys" else nT - 1 - z // 2
            rows[role] += [(bi, ci, h, r) for r in
                           range(tile * TILE, min(Q, tile * TILE + TILE))]
    return rows


def _strides4(t: torch.Tensor):
    """Element strides of the (b, chunk, q, head) axes."""
    return t.stride()[:4]


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, dA: torch.Tensor, dy: torch.Tensor,
                  dS: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K5's inputs as its forward takes them (x (b,nc,Q,H,P), dt/dA
    (b,nc,Q,H) f32, B/C (b,nc,Q,H,N), x, B, C of one dtype, f32 or bf16),
    dy (b,nc,Q,H,P) and dS (b,nc,H,N,P) -> (dx, ddt, dB, dC, ddA): dx,
    dB, dC (per head) in the inputs' dtype, ddt and ddA f32."""
    return run(x, dt, B, C, dA, dy, dS)


def run(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        dA: torch.Tensor, dy: torch.Tensor, dS: torch.Tensor,
        kernel: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """:func:`ssd_chunk_bwd` with :func:`plan`'s route, or with the route
    ``kernel`` given (checks of each route)."""
    _build.check_cuda("ssd_chunk_bwd", [x, dt, B, C, dA, dy, dS])
    require(x.dim() == 5 and B.dim() == 5 and C.shape == B.shape,
            f"ssd_chunk_bwd: bad shapes x {tuple(x.shape)}, B "
            f"{tuple(B.shape)}, C {tuple(C.shape)}")
    b, nc, Q, H, Pd = x.shape
    N = B.shape[-1]
    require(tuple(B.shape[:4]) == (b, nc, Q, H)
            and tuple(dt.shape) == (b, nc, Q, H) and dA.shape == dt.shape
            and dy.shape == x.shape and tuple(dS.shape) == (b, nc, H, N, Pd),
            f"ssd_chunk_bwd: x {tuple(x.shape)} vs B {tuple(B.shape)}, dt "
            f"{tuple(dt.shape)}, dA {tuple(dA.shape)}, dy {tuple(dy.shape)},"
            f" dS {tuple(dS.shape)}")
    require(x.dtype in _build.DTYPE_CODES and B.dtype == x.dtype
            and C.dtype == x.dtype,
            f"ssd_chunk_bwd: dtypes x {x.dtype}, B {B.dtype}, C {C.dtype} "
            f"unsupported")
    require(all(t.dtype == torch.float32 for t in (dt, dA, dy, dS)),
            f"ssd_chunk_bwd: dt, dA, dy, dS must be f32, got "
            f"{[str(t.dtype) for t in (dt, dA, dy, dS)]}")
    require(x.stride(-1) == 1 and B.stride(-1) == 1 and C.stride(-1) == 1,
            "ssd_chunk_bwd: x, B, C must be unit-stride on their last axis")
    p = plan(b, nc, Q, H, Pd, N, x.dtype, kernel, _card(x.device))
    if p.kernel == "ssd_bwd_mma":
        # its 16-byte copies need rows that start on 16 bytes: the model's
        # tensors do; any other view is copied
        x, B, C = (t if rows_aligned(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (x, B, C))
    dy, dS = dy.contiguous(), dS.contiguous()
    dx = torch.empty((b, nc, Q, H, Pd), dtype=x.dtype, device=x.device)
    dB, dC = (torch.empty((b, nc, Q, H, N), dtype=x.dtype, device=x.device)
              for _ in range(2))
    ddt, ddA = (torch.empty((b, nc, Q, H), dtype=torch.float32,
                            device=x.device) for _ in range(2))
    part = torch.empty((b * nc, H, PARTS, Q), dtype=torch.float32,
                       device=x.device)
    lib = _build.library("ssd_chunk_bwd", _SIG)
    rc = lib.repro_ssd_chunk_bwd(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        dA.data_ptr(), dy.data_ptr(), dS.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(), ddA.data_ptr(),
        part.data_ptr(), _build.DTYPE_CODES[x.dtype], KERNEL_IDS[p.kernel],
        b, nc, Q, H, Pd, N,
        *_strides4(x), *_strides4(dt), *_strides4(B), *_strides4(C),
        *_strides4(dA), _build.stream_ptr(x))
    _build.check(lib, rc, f"ssd_chunk_bwd ({p.kernel})")
    launches.add()
    return dx, ddt, dB, dC, ddA


def flops(x: torch.Tensor, B: torch.Tensor) -> list:
    """-> [(flops, rate)]: 2 flops a multiply-add.  Over the Q(Q+1)/2
    visible pairs: the scores C·Bᵀ (the inputs' own type with f32 sums,
    exact on the bf16 tensor cores); Mᵀ·dy, both operands f32, at f32
    accuracy on the TF32 tensor cores split three ways ("tf32x3"); and
    dM = (dy·xᵀ) ⊙ dt, dC = (dM ⊙ L)·B and dB = (dM ⊙ L)ᵀ·C, with the
    state terms B·dS, x·dSᵀ and dw = B·(dS·dtx), each of which has an
    operand of the inputs' type: in bf16, exact in TF32, so two products
    of the split f32 operand do ("tf32x2"); in f32, three.  The
    elementwise exp and scaling are not counted."""
    b, nc, Q, H, Pd = x.shape
    N = B.shape[-1]
    pairs = Q * (Q + 1) // 2
    cells = 2 * b * nc * H
    bf16 = x.dtype == torch.bfloat16
    return [(cells * pairs * N, torch.bfloat16 if bf16 else "tf32x3"),
            (cells * pairs * Pd, "tf32x3"),
            (cells * (pairs * (Pd + 2 * N) + 2 * Q * N * Pd + Q * N),
             "tf32x2" if bf16 else "tf32x3")]


def bytes_moved(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, dA: torch.Tensor) -> int:
    """Each input's distinct elements read once (x, dt, B, C, dA, and dy
    and dS in f32), each gradient written once (dx, dB, dC per head in
    the inputs' dtype; ddt, ddA f32)."""
    b, nc, Q, H, Pd = x.shape
    N = B.shape[-1]
    e = x.element_size()
    cells = b * nc * H
    return (sum(_distinct_bytes(t) for t in (x, dt, B, C, dA))
            + 4 * cells * (Q * Pd + N * Pd)              # dy, dS
            + e * cells * Q * (Pd + 2 * N) + 8 * cells * Q)
