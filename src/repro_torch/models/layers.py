"""Dense (GQA) transformer layers — port of ``repro/models/layers.py``.

Plain functions on tensors; parameters come in as mappings with the JAX
package's names and layouts (``wq (d,h,e)``, ``wk``/``wv (d,n,e)``,
``wo (h,e,d)``, ``w_up``/``w_gate (d,f)``, ``w_down (f,d)``, f32 norm
``scale``).  Activations are ``(b, s, h, e)``; caches ``(b, S, n, e)``.
Matmuls run in the parameter dtype, softmax and norms in float32.

``mha`` is the plain reference attention.  ``attention`` sends the dense
family and the hybrid family's shared block through the kernels
(``kernels/ops.py``): the flash kernel for no cache or a prefill chunk,
the decode kernel for a single new token.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init helpers (the JAX package's distributions; not its bits)
# ---------------------------------------------------------------------------

def dense_init(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by fan_in**-0.5 (``shape[0]``)."""
    scale = scale if scale is not None else shape[0] ** -0.5
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def embed_init(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    return dense_init(shape, dtype, generator, device, scale=1.0)


# ---------------------------------------------------------------------------
# RMSNorm / RoPE
# ---------------------------------------------------------------------------

def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., seq, heads, head_dim); positions (..., seq).  Split-half
    rotation (not interleaved)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * inv           # (..., s, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (b,sq,h,e), k (b,sk,n,e) -> f32 scores (b,n,g,sq,sk)."""
    b, sq, h, e = q.shape
    n = k.shape[2]
    q = q.reshape(b, sq, n, h // n, e)
    return torch.einsum("bqnge,bkne->bngqk", q.float(), k.float())


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (b,n,g,sq,sk), v (b,sk,n,e) -> (b,sq,h,e)."""
    b, n, g, sq, sk = probs.shape
    out = torch.einsum("bngqk,bkne->bqnge", probs, v)
    return out.reshape(b, sq, n * g, out.shape[-1])


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
        q_positions: Optional[torch.Tensor] = None,
        kv_positions: Optional[torch.Tensor] = None,
        kv_valid_len: Optional[torch.Tensor] = None,
        window: int = 0) -> torch.Tensor:
    """Plain multi-head GQA attention: the reference the kernels are held
    to.  q (b,sq,h,e), k/v (b,sk,n,e).  Masks are top-left aligned
    (positions default to ``arange``); ``kv_valid_len`` (b,) masks a cache
    tail; fully masked rows output 0; probabilities are cast to v's dtype
    before P.V."""
    b, sq, h, e = q.shape
    sk = k.shape[1]
    scores = _gqa_scores(q, k) / math.sqrt(e)
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(sk, device=q.device)
    qp = q_positions.reshape(-1, 1) if q_positions.dim() == 1 else q_positions
    kp = (kv_positions.reshape(1, -1) if kv_positions.dim() == 1
          else kv_positions)
    mask = None
    if causal:
        mask = qp >= kp
    if window > 0:
        wmask = qp - kp < window
        mask = wmask if mask is None else (mask & wmask)
    if kv_valid_len is not None:
        vmask = kv_positions.reshape(1, -1) < kv_valid_len.reshape(-1, 1)
        scores = scores.masked_fill(~vmask[:, None, None, None, :],
                                    float("-inf"))
    if mask is not None:
        while mask.dim() < 5:
            mask = mask[None]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs).to(v.dtype)
    return _gqa_out(probs, v)


def attention(p: Params, x: torch.Tensor, *, positions: torch.Tensor,
              theta: float, causal: bool = True,
              cache: Optional[Mapping[str, torch.Tensor]] = None,
              cache_idx: Optional[int] = None, window: int = 0,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Optional[Mapping[str, torch.Tensor]]]:
    """QKV projection + RoPE + attention + output projection.

    ``cache`` {"k", "v"}: (b, S, n, e) tensors, written IN PLACE at
    ``cache_idx`` (a host int) — unlike the JAX version, which returns an
    updated copy; the returned cache is the same mapping.  Attention then
    reads the valid prefix ``[:cache_idx + sq]`` as a view.

    ``window`` > 0 (sliding window) and ``kv_override`` (cross-attention)
    are off the ported paths (the dense family, and the hybrid family's
    shared block below the ring cache's 32768 positions): they run the
    plain ``mha`` on the CPU and raise on CUDA until the ring cache and the
    vlm/audio families are ported with windowed and cross-attention
    kernels.
    """
    dtype = x.dtype
    if (window > 0 or kv_override is not None) and x.is_cuda:
        raise NotImplementedError(
            "sliding-window and cross-attention have no CUDA kernel yet; "
            "they come with the ring cache and the vlm/audio families")
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if kv_override is not None:
        k, v = kv_override
        out = mha(q.to(dtype), k, v, causal=False)
    else:
        k = torch.einsum("bsd,dne->bsne", x, p["wk"])
        v = torch.einsum("bsd,dne->bsne", x, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
        if cache is not None:
            kc, vc = cache["k"], cache["v"]
            S, sq = kc.shape[1], q.shape[1]
            valid = cache_idx + sq
            if valid > S:
                raise ValueError(f"cache overflow: {valid} > {S} positions")
            kc[:, cache_idx:valid] = k.to(kc.dtype)
            vc[:, cache_idx:valid] = v.to(vc.dtype)
            if window > 0:
                out = mha(q, kc, vc, causal=True, q_positions=positions,
                          kv_positions=torch.arange(S, device=x.device),
                          kv_valid_len=torch.full((x.shape[0],), valid,
                                                  device=x.device),
                          window=window)
            elif sq == 1:
                lengths = torch.full((x.shape[0],), valid, dtype=torch.int32,
                                     device=x.device)
                out = ops.decode_attention(q[:, 0], kc[:, :valid],
                                           vc[:, :valid], lengths)[:, None]
            else:
                out = ops.flash_attention(q, kc[:, :valid], vc[:, :valid],
                                          causal=True, q_offset=cache_idx)
        elif window > 0:
            out = mha(q, k, v, causal=causal, q_positions=positions,
                      kv_positions=positions, window=window)
        else:
            out = ops.flash_attention(q, k, v, causal=causal)
    y = torch.einsum("bshe,hed->bsd", out.to(dtype), p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return h @ p["w_down"]
