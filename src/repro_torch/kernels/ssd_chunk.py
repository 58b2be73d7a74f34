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
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, L, P, require

MAX_Q = 256          # one scan element per thread (kMaxQ)
MAX_WIDTH = 64       # P and N are zero-padded to the 64-wide tile (kT)
_SIG = {"repro_ssd_chunk": [P] * 7 + [I] * 7 + [L] * 20 + [P]}

launches = _build.LaunchCounter()


def _strides4(t: torch.Tensor):
    """Element strides of the (b, chunk, q, head) axes."""
    return t.stride()[:4]


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor,
              dA: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,nc,Q,H,P); dt/dA (b,nc,Q,H) f32; B/C (b,nc,Q,H,N) ->
    (y (b,nc,Q,H,P) f32, S (b,nc,H,N,P) f32).  x, B and C share one dtype
    (f32 or bf16) and are unit-stride on their last axis."""
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
    y = torch.empty((b, nc, Q, H, Pd), dtype=torch.float32, device=x.device)
    S = torch.empty((b, nc, H, N, Pd), dtype=torch.float32, device=x.device)
    lib = _build.library("ssd_chunk", _SIG)
    rc = lib.repro_ssd_chunk(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        dA.data_ptr(), y.data_ptr(), S.data_ptr(),
        _build.DTYPE_CODES[x.dtype], b, nc, Q, H, Pd, N,
        *_strides4(x), *_strides4(dt), *_strides4(B), *_strides4(C),
        *_strides4(dA), _build.stream_ptr(x))
    _build.check(lib, rc, "ssd_chunk")
    launches.add()
    return y, S


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


def flops(x: torch.Tensor, B: torch.Tensor) -> Tuple[int, int]:
    """-> (scores, f32): flops (2 per multiply-add) of the causal scores
    C·Bᵀ over the Q(Q+1)/2 visible pairs, a product of the inputs' own
    type with f32 sums, which that type's tensor cores compute exactly;
    and of the products on f32 operands, (scores ⊙ L)(dt·x) over the same
    pairs and the state (B ⊙ decay)ᵀ(dt·x).  The elementwise exp and
    scaling are not counted."""
    b, nc, Q, H, Pd = x.shape
    N = B.shape[-1]
    pairs = Q * (Q + 1) // 2
    cells = 2 * b * nc * H
    return cells * pairs * N, cells * (pairs * Pd + Q * N * Pd)
