"""K5's backward on Hopper — wrapper of ``csrc/ssd_chunk_bwd.cu``.

The gradients of K5 (:func:`ssd_chunk.ssd_chunk`, the Mamba2 SSD
intra-chunk term and chunk states) with respect to x, dt, B, C and dA,
given the cotangents dy and dS.  Two launches with no float atomics, so
a gradient is the same in every run: ``ssd_bwd_tiles`` (a block per
(head, batch x chunk, 64-row tile) in two roles: a key tile writes dx,
ddt and dB and G's column sums, a query tile dC and G's row sums) and
``ssd_bwd_finish`` (a block per (head, batch x chunk): the f64 scans into
ddA).  Every product runs in f32 on the CUDA cores.  The derivation is
in the source's header.

B and C come per head (a stride-0 view broadcast from one group is read
in place) and dB, dC leave per head, in the inputs' dtype: autograd's
backward of the model's broadcast sums a group's heads
(``models/ssm.py``'s ``_heads``).

The JAX package has no backward Pallas kernel: it differentiates
``repro/models/ssm.py::mamba2_forward`` with XLA;
``kernels/ref.py::ssd_chunk_bwd_ref`` is the plain version, step by step.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, L, P, require
from repro_torch.kernels.ssd_chunk import (H100, MAX_Q, MAX_WIDTH, _card,
                                           _distinct_bytes)

TILE = 64            # rows and keys of a tile; MAX_WIDTH pads P and N to it
PARTS = 3            # a cell's row sums, column sums and w terms (f32)
# ssd_bwd_tiles' shared memory: the f64 scan and f32 cs (MAX_Q each) and
# six 64 x 65 f32 tiles (kSmem in csrc/ssd_chunk_bwd.cu)
SMEM = MAX_Q * 8 + MAX_Q * 4 + 6 * TILE * (TILE + 1) * 4
_SIG = {"repro_ssd_chunk_bwd": [P] * 13 + [I] * 7 + [L] * 20 + [P]}

launches = _build.LaunchCounter()


class Plan(NamedTuple):
    """The two launches: ``ssd_bwd_tiles``' grid (heads, batch x chunk,
    2 x 64-row tiles) and shared memory, ``ssd_bwd_finish``'s grid."""
    tiles: Tuple[int, int, int]
    smem: int
    finish: Tuple[int, int]


def plan(b: int, nc: int, Q: int, H: int, P: int, N: int,
         dtype: torch.dtype, card: Tuple[int, int] = H100) -> Plan:
    """The launch of one call on a card of ``card`` = (SMs, a block's
    most shared memory in bytes).  One layout serves both input types
    (every tile is f32 in shared memory), so the shared memory is the
    same at every Q."""
    require(dtype in _build.DTYPE_CODES, f"ssd_chunk_bwd: dtype {dtype} "
            f"unsupported")
    require(1 <= Q <= MAX_Q, f"ssd_chunk_bwd: chunk length {Q} not in "
            f"[1, {MAX_Q}]")
    require(1 <= P <= MAX_WIDTH and 1 <= N <= MAX_WIDTH,
            f"ssd_chunk_bwd: head dim {P} / state {N} not in "
            f"[1, {MAX_WIDTH}]")
    require(b * nc >= 1 and H >= 1, "ssd_chunk_bwd: empty input")
    require(SMEM <= card[1], f"ssd_chunk_bwd: {SMEM} bytes of shared "
            f"memory a block, the card allows {card[1]}")
    return Plan((H, b * nc, 2 * -(-Q // TILE)), SMEM, (H, b * nc))


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
    plan(b, nc, Q, H, Pd, N, x.dtype, _card(x.device))     # checks
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
        part.data_ptr(), _build.DTYPE_CODES[x.dtype], b, nc, Q, H, Pd, N,
        *_strides4(x), *_strides4(dt), *_strides4(B), *_strides4(C),
        *_strides4(dA), _build.stream_ptr(x))
    _build.check(lib, rc, "ssd_chunk_bwd")
    launches.add()
    return dx, ddt, dB, dC, ddA


def flops(x: torch.Tensor, B: torch.Tensor) -> list:
    """-> [(flops, rate)]: 2 flops a multiply-add.  Over the Q(Q+1)/2
    visible pairs, the scores C·Bᵀ (the inputs' own type with f32 sums,
    exact on the bf16 tensor cores) and four products on f32 operands
    (dM = dy·dtxᵀ, Mᵀ·dy, dC = (dM ⊙ L)·B, dB = (dM ⊙ L)ᵀ·C), and the
    state terms B·dS, dS·dtx and dw = B·(dS·dtx), priced at f32
    accuracy on the TF32 tensor cores split three ways ("tf32x3"); the
    elementwise exp and scaling are not counted."""
    b, nc, Q, H, Pd = x.shape
    N = B.shape[-1]
    pairs = Q * (Q + 1) // 2
    cells = 2 * b * nc * H
    scores = torch.bfloat16 if x.dtype == torch.bfloat16 else "tf32x3"
    return [(cells * pairs * N, scores),
            (cells * (pairs * (2 * Pd + 2 * N) + 2 * Q * N * Pd + Q * N),
             "tf32x3")]


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
