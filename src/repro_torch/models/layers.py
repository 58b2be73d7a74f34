"""Dense (GQA) transformer layers — port of ``repro/models/layers.py``.

Plain functions on tensors; parameters come in as mappings with the JAX
package's names and layouts (``wq (d,h,e)``, ``wk``/``wv (d,n,e)``,
``wo (h,e,d)``, ``w_up``/``w_gate (d,f)``, ``w_down (f,d)``, f32 norm
``scale``).  Activations are ``(b, s, h, e)``; caches ``(b, S, n, e)``.
Matmuls run in the parameter dtype, softmax and norms in float32.

``mha`` is the plain reference attention.  ``attention`` sends every
attention through the kernels (``kernels/ops.py``): the flash kernel for
no cache, a prefill chunk or a cross-attention over several queries, the
decode kernel for a single new token; a sliding window goes to their
window mode, a cross-attention (``kv_override``) to their non-causal
and full-length forms.
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
        window: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Plain multi-head GQA attention: the reference the kernels are held
    to.  q/k (b,s,h|n,e), v (b,sk,n,e_v) (e_v may differ from e, as in
    MLA).  Scores are scaled by ``scale`` (default 1/sqrt(e)).  Masks are
    top-left aligned (positions default to ``arange``); ``kv_valid_len``
    (b,) masks a cache tail; fully masked rows output 0; probabilities are
    cast to v's dtype before P.V."""
    b, sq, h, e = q.shape
    sk = k.shape[1]
    scores = _gqa_scores(q, k)
    scores = scores / math.sqrt(e) if scale is None else scores * scale
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

    ``window`` > 0: a sliding window over the cache (or the sequence)
    in position order, each slot's position its index; the hybrid
    family's ring cache attends through :func:`attend_cache` with its own
    slot positions instead.  ``kv_override`` (k, v) (b, T, n, e):
    cross-attention over a source of T rows, no RoPE, no mask.
    """
    b, sq = x.shape[:2]
    if kv_override is not None:
        q = project_q(p, x)
        k, v = kv_override
        if sq == 1:
            full = torch.full((b,), k.shape[1], dtype=torch.int32,
                              device=x.device)
            out = ops.decode_attention(q[:, 0], k, v, full)[:, None]
        else:
            out = ops.flash_attention(q, k, v, causal=False)
        return project_out(p, out, x.dtype), cache
    q, k, v = project_qkv(p, x, positions, theta)
    if cache is None:
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  kv_positions=_in_order(sq, window, x))
        return project_out(p, out, x.dtype), cache
    kc, vc = cache["k"], cache["v"]
    valid = cache_idx + sq
    if valid > kc.shape[1]:
        raise ValueError(f"cache overflow: {valid} > {kc.shape[1]} "
                         f"positions")
    kc[:, cache_idx:valid] = k.to(kc.dtype)
    vc[:, cache_idx:valid] = v.to(vc.dtype)
    out = attend_cache(q, kc[:, :valid], vc[:, :valid], cache_idx,
                       kv_positions=_in_order(valid, window, x),
                       window=window)
    return project_out(p, out, x.dtype), cache


def _in_order(n: int, window: int,
              like: torch.Tensor) -> Optional[torch.Tensor]:
    """The slot positions of n keys held in position order (slot i holds
    position i), as the kernels' window mode reads them; None without a
    window."""
    return (torch.arange(n, dtype=torch.int32, device=like.device)
            if window > 0 else None)


def project_q(p: Params, x: torch.Tensor) -> torch.Tensor:
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    return q + p["bq"] if "bq" in p else q


def project_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor,
                theta: float):
    """-> q (b,s,h,e), k, v (b,s,n,e), RoPE on q and k."""
    q = project_q(p, x)
    k = torch.einsum("bsd,dne->bsne", x, p["wk"])
    v = torch.einsum("bsd,dne->bsne", x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return (apply_rope(q, positions, theta), apply_rope(k, positions, theta),
            v)


def project_out(p: Params, out: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    return torch.einsum("bshe,hed->bsd", out.to(dtype), p["wo"])


def attend_cache(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 q_offset: int, *, kv_positions: Optional[torch.Tensor] = None,
                 window: int = 0) -> torch.Tensor:
    """Causal attention of queries at ``q_offset + i`` over every slot of
    the cache view (b, S, n, e), already written: K1 for one query, K2
    for more.  ``kv_positions`` (S,) int32: each slot's position (a ring);
    ``window`` > 0: the sliding window."""
    b, sq = q.shape[:2]
    S = kc.shape[1]
    if sq > 1:
        return ops.flash_attention(q, kc, vc, causal=True,
                                   q_offset=q_offset,
                                   kv_positions=kv_positions, window=window)
    lengths = torch.full((b,), S, dtype=torch.int32, device=q.device)
    wm = {}
    if window > 0:
        wm = dict(kv_positions=kv_positions, window=window,
                  q_pos=torch.full((b,), q_offset, dtype=torch.int32,
                                   device=q.device))
    return ops.decode_attention(q[:, 0], kc, vc, lengths, **wm)[:, None]


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
