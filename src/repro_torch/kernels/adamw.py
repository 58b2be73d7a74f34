"""AdamW over every leaf in one pass on Hopper — wrapper of
``csrc/adamw.cu``.

Replaces no TPU kernel: the JAX package leaves AdamW to XLA.  The plain
version is the per-leaf loop of ``training/optimizer.py``
(``plain_update``), which runs on the CPU; on the card
``optimizer.adamw_update`` comes here through ``ops.adamw`` (the row of
``ops.OPTIMIZER_KERNELS``).  One call is two launches for up to
``MAX_LEAVES`` leaves (``adamw_sumsq``, the gradients' global norm as
per-block partial sums, then ``adamw_step``, the clip and the update of
every leaf), and updates the parameters and both moments in place.

Types, per leaf: parameters bf16 or f32, gradients bf16 or f32 (f32 under
gradient accumulation), moments f32 or bf16 (``state_dtype``), m and v
of one type.  Anything else raises.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P, require

MAX_LEAVES = 512        # leaves a launch (kMaxLeaves)
TILE = 8192             # elements of a tile (kTile)
BLOCKS_PER_SM = 4       # blocks of 256 threads an SM, each launch
# 2 for the norm (a square and a sum), 17 for the update (the clip's
# product, 3 for m, 4 for v, 2 bias corrections, sqrt, eps, the quotient,
# the decay's product and sum, lr's product, the difference)
FLOPS_PER_ELEMENT = 19
_TYPES = (torch.float32, torch.bfloat16)
_SIG = {"repro_adamw": [P] * 3 + [I] + [P] * 5 + [F] * 8 + [I, P]}

launches = _build.LaunchCounter()   # calls, each the two-kernel pair
leaves = 0                          # leaves updated by the last call


def leaf_code(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor) -> int:
    """A leaf's types and alignment as ``csrc/adamw.cu`` reads them: bit 0
    bf16 parameter, bit 1 bf16 gradient, bit 2 bf16 moments, bit 3 all
    four arrays 16-byte aligned (the vector path)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (p, g, m, v))
    return ((p.dtype == torch.bfloat16) | (g.dtype == torch.bfloat16) << 1
            | (m.dtype == torch.bfloat16) << 2 | aligned << 3)


def chunks(count: int) -> int:
    """Launch pairs of one call: a pair per ``MAX_LEAVES`` leaves."""
    return -(-count // MAX_LEAVES)


def adamw(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
          m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
          lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor, *,
          b1: float, b2: float, eps: float, weight_decay: float,
          grad_clip: float, norm_floor: float) -> torch.Tensor:
    """One AdamW step of every leaf, in place -> the gradients' global
    norm (0-d f32).  ``lr``, ``bc1``, ``bc2``: 0-d f32 on the device (the
    schedule's); the constants are rounded to f32 as torch rounds a Python
    scalar (ctypes' ``c_float`` rounds to nearest): ``1 - b1`` and
    ``1 - b2`` from their doubles."""
    n = len(params)
    require(n >= 1 and len(grads) == len(m) == len(v) == n,
            f"adamw: {n} parameters, {len(grads)} gradients, {len(m)} and "
            f"{len(v)} moments")
    scalars = (lr, bc1, bc2)
    _build.check_cuda("adamw", [*params, *grads, *m, *v, *scalars])
    require(all(s.dtype == torch.float32 and s.numel() == 1
                for s in scalars), "adamw: lr, bc1, bc2 must be f32 scalars")
    for i, (p, g, mi, vi) in enumerate(zip(params, grads, m, v)):
        if not (p.shape == g.shape == mi.shape == vi.shape
                and p.dtype in _TYPES and g.dtype in _TYPES
                and mi.dtype in _TYPES and vi.dtype == mi.dtype
                and p.is_contiguous() and g.is_contiguous()
                and mi.is_contiguous() and vi.is_contiguous()):
            raise ValueError(
                f"adamw: leaf {i} must be contiguous with one shape and "
                f"types f32 or bf16 (m and v alike): p {tuple(p.shape)} "
                f"{p.dtype}, g {tuple(g.shape)} {g.dtype}, m "
                f"{tuple(mi.shape)} {mi.dtype}, v {tuple(vi.shape)} "
                f"{vi.dtype}")
    ptrs = np.array([[t.data_ptr() for t in ts]
                     for ts in (params, grads, m, v)], dtype=np.uint64)
    numel = np.array([p.numel() for p in params], dtype=np.int64)
    code = np.array([leaf_code(*t) for t in zip(params, grads, m, v)],
                    dtype=np.int32)
    dev = params[0].device
    grid = BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count
    partials = torch.empty(chunks(n) * grid, dtype=torch.float64,
                           device=dev)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.library("adamw", _SIG)
    rc = lib.repro_adamw(
        ptrs.ctypes.data, numel.ctypes.data, code.ctypes.data, n,
        partials.data_ptr(), gnorm.data_ptr(), lr.data_ptr(),
        bc1.data_ptr(), bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps,
        weight_decay, grad_clip, norm_floor, grid, _build.stream_ptr(gnorm))
    _build.check(lib, rc, "adamw")
    launches.add()
    global leaves
    leaves = n
    return gnorm


def bytes_moved(params, grads, m, v) -> int:
    """p, m and v read and written, g read twice (the norm, the update)."""
    return sum(p.numel() * 2 * (p.element_size() + g.element_size()
                                + mi.element_size() + vi.element_size())
               for p, g, mi, vi in zip(params, grads, m, v))


def flops(params) -> int:
    return FLOPS_PER_ELEMENT * sum(p.numel() for p in params)
