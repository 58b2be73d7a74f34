"""K4: int8 × int8 matrix product with dequant on Hopper — wrapper of
``csrc/int8_matmul.cu``, and the plain ``quantize_int8``.

Replaces the Pallas TPU kernel ``repro/kernels/int8_matmul.py``: int8
``x (M,K)`` times int8 ``w (K,N)`` summed in int32, then ``(acc·sx)·sw``
in f32 with per-row activation scales ``sx (M,1)`` and per-column weight
scales ``sw (1,N)``, cast to ``out_dtype``.  Shapes with K and N
multiples of 16 run ``int8_mm_wgmma`` on the int8 tensor cores, others
the ``__dp4a`` kernel ``int8_mm`` (:func:`kernel_for`).  Like the
reference, nothing on the serving path calls it: it is a kernel of its
own, checked on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import I, P, require

_SIG = {"repro_int8_matmul": [P] * 5 + [I] * 5 + [P]}

launches = _build.LaunchCounter()


def quantize_int8(x: torch.Tensor,
                  axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization -> (q int8, scale f32 with
    ``axis`` kept as size 1), as ``repro/kernels/int8_matmul.py``:
    ``scale = max(amax, 1e-8) / 127``, ``q = clip(round(x / scale))``
    (round half to even, as ``jnp.round``)."""
    amax = x.float().abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M,K) int8, w (K,N) int8, sx (M,1) f32, sw (1,N) f32 -> (M,N)
    ``out_dtype`` (bf16 or f32)."""
    _build.check_cuda("int8_matmul", [x, w, sx, sw])
    require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0],
            f"int8_matmul: bad shapes x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    require(M >= 1 and N >= 1 and K >= 1, "int8_matmul: empty input")
    require(x.dtype == torch.int8 and w.dtype == torch.int8,
            f"int8_matmul: x/w must be int8, got {x.dtype}/{w.dtype}")
    require(tuple(sx.shape) == (M, 1) and tuple(sw.shape) == (1, N)
            and sx.dtype == torch.float32 and sw.dtype == torch.float32,
            f"int8_matmul: scales must be f32 (M,1) and (1,N), got "
            f"{tuple(sx.shape)} {sx.dtype}, {tuple(sw.shape)} {sw.dtype}")
    require(out_dtype in _build.DTYPE_CODES,
            f"int8_matmul: out_dtype {out_dtype} unsupported")
    require(all(t.is_contiguous() for t in (x, w, sx, sw)),
            "int8_matmul: inputs must be contiguous")
    wgmma = kernel_for(M, N, K) == "int8_mm_wgmma"
    if wgmma:   # TMA and 16-byte rows of w need 16-byte aligned bases
        x, w = (t if t.data_ptr() % 16 == 0 else t.clone()
                for t in (x, w))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = _build.library("int8_matmul", _SIG)
    rc = lib.repro_int8_matmul(x.data_ptr(), w.data_ptr(), sx.data_ptr(),
                               sw.data_ptr(), out.data_ptr(),
                               _build.DTYPE_CODES[out_dtype], M, N, K,
                               int(wgmma), _build.stream_ptr(x))
    _build.check(lib, rc, "int8_matmul")
    launches.add()
    return out


def kernel_for(M: int, N: int, K: int) -> str:
    """The ``__global__`` that runs an (M,K)·(K,N) product: the int8
    tensor cores where K and N are multiples of 16 (x's rows by TMA, w's
    in 16-byte pieces), else the ``__dp4a`` kernel."""
    if K % 16 == 0 and N % 16 == 0:
        return "int8_mm_wgmma"
    return "int8_mm"


def bytes_moved(x: torch.Tensor, w: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> int:
    """x, w and both scales read once; the output written once."""
    M, K = x.shape
    N = w.shape[1]
    return M * K + K * N + 4 * (M + N) + M * N * out_dtype.itemsize


def ops(x: torch.Tensor, w: torch.Tensor) -> int:
    """2·M·N·K int8 operations (a multiply and an add per product)."""
    return 2 * x.shape[0] * x.shape[1] * w.shape[1]
