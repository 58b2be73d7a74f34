"""Matrix products of the reference at a stated precision: ``f32`` (the
reference) and ``fp8`` (the control for a bf16 configuration: both
operands rounded to float8 e4m3 with a per-row / per-column scale, the
product accumulated in f32)."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim`` (the
    amax over ``dim``), returned in f32; the gradient passes straight
    through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, precision: str = "f32"
       ) -> torch.Tensor:
    """x (..., k) @ w (k, n) in f32 at ``precision``."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w
