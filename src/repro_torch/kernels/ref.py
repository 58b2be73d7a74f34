"""Plain PyTorch versions of the kernels K1–K5: the CPU path, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.

K1 and K2 take a window mode (``window`` > 0) for the hybrid family's
sliding-window ring cache: key slot ``j`` has position ``kv_positions[j]``,
and a query at ``qpos`` sees it iff ``qpos - window < kpos <= qpos`` (``<= qpos`` only where causal),
tested in int64 as ``kpos > qpos - window``: an empty ring slot holds
``NEG_POS = -(1 << 30)`` and only the window masks it.  This is the mask
of ``repro/models/layers.py::mha`` with ``kv_positions`` and ``window``.

K1 and K2 also take an MLA mode (DeepSeek's multi-head latent attention,
``repro/models/mla.py``): values narrower than the keys (e_v < e) and an
explicit ``scale`` (MLA scales by 1/sqrt(qk_head_dim), not by
1/sqrt(e)); the plain versions take both.

K2's backward (training; no window or MLA mode) has its plain version
here too: :func:`flash_attention_lse_ref` gives the forward's LSE and
:func:`flash_attention_bwd_ref` the gradients from it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_POS = -(1 << 30)        # a ring slot that holds no position yet


def ring_positions(W: int, end: int, device=None) -> torch.Tensor:
    """(W,) int32 slot positions of a W-slot ring after positions
    0..end-1 were written at slot ``p % W``, as the model writes them: the
    last W of them, ``NEG_POS`` where a slot is still empty."""
    pos = torch.full((W,), NEG_POS, dtype=torch.int32)
    p = torch.arange(max(0, end - W), end, dtype=torch.int32)
    pos[p % W] = p
    return pos.to(device)


def visible(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int,
            causal: bool = True) -> torch.Tensor:
    """Query positions (..., sq) and key positions (sk,) -> bool (..., sq,
    sk): ``kpos > qpos - window`` (if ``window`` > 0) and ``kpos <= qpos``
    (if ``causal``), in int64."""
    qp, kp = q_pos.long()[..., None], kv_pos.long()
    mask = torch.ones(qp.shape[:-1] + kp.shape, dtype=torch.bool,
                      device=kp.device)
    if window > 0:
        mask &= kp > qp - window
    if causal:
        mask &= kp <= qp
    return mask


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``mha`` under an explicit mask (b or 1, sq, sk) of visible (query,
    key) pairs: f32 scores, fully masked rows output 0, probabilities cast
    to v's dtype before P.V."""
    from repro_torch.models.layers import _gqa_out, _gqa_scores
    scores = _gqa_scores(q, k)
    scores = (scores / math.sqrt(q.shape[-1]) if scale is None
              else scores * scale)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs).to(v.dtype)
    return _gqa_out(probs, v)


def valid_slots(n: int, upto, device) -> torch.Tensor:
    """(b or 1, n) bool: slot j < upto (a length per row, or one int)."""
    ar = torch.arange(n, device=device)
    if isinstance(upto, torch.Tensor):
        return ar[None] < upto.to(device).reshape(-1, 1)
    return (ar < upto)[None]


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         kv_positions: Optional[torch.Tensor] = None,
                         q_pos: Optional[torch.Tensor] = None,
                         window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q (b,h,e); caches k (b,S,n,e), v (b,S,n,e_v); lengths (b,): slots
    ``>= lengths[b]`` are masked.  With ``window`` > 0, also the window
    mode's mask for queries at ``q_pos`` (b,) over ``kv_positions``
    (S,)."""
    if window <= 0:
        from repro_torch.models.layers import mha
        return mha(q[:, None], k_cache, v_cache, causal=False,
                   kv_valid_len=lengths, scale=scale)[:, 0]
    S = k_cache.shape[1]
    mask = (visible(q_pos[:, None], kv_positions, window)
            & valid_slots(S, lengths, q.device)[:, None])
    return masked_attention(q[:, None], k_cache, v_cache, mask,
                            scale)[:, 0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        kv_len: Optional[int] = None,
                        kv_positions: Optional[torch.Tensor] = None,
                        window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (b,sq,h,e), k (b,sk,n,e), v (b,sk,n,e_v) GQA; query i sits at
    q_offset + i; slots ``>= kv_len`` are masked.  With ``window`` > 0,
    the window mode's mask over the slots' ``kv_positions`` (sk,)."""
    if window <= 0:
        from repro_torch.models.layers import mha
        qpos = torch.arange(q.shape[1], device=q.device) + q_offset
        valid = (None if kv_len is None else
                 torch.full((q.shape[0],), kv_len, dtype=torch.int32,
                            device=q.device))
        return mha(q, k, v, causal=causal, q_positions=qpos,
                   kv_valid_len=valid, scale=scale)
    sk = k.shape[1]
    qpos = torch.arange(q.shape[1], device=q.device) + q_offset
    mask = visible(qpos, kv_positions, window, causal)[None]
    if kv_len is not None:
        mask = mask & valid_slots(sk, kv_len, q.device)[:, None]
    return masked_attention(q, k, v, mask, scale)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            q_offset: int = 0,
                            kv_len: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` (v may be narrower than k, as in the
    naive MLA form) and each query row's log-sum-exp of its visible
    scores times ``scale`` (else 1/sqrt(e)), f32 (b, h, sq) in natural-log
    units (-inf for a row with no visible key): what K2 writes for its
    backward."""
    out = flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len, scale=scale)
    scores = _masked_scores(q, k, causal, q_offset, kv_len, scale)
    b, n, g, sq, _ = scores.shape
    lse = torch.logsumexp(scores, dim=-1).reshape(b, n * g, sq)
    return out, lse


def _masked_scores(q, k, causal, q_offset, kv_len, scale=None):
    """f32 scores (b, n, g, sq, sk) times ``scale`` (else 1/sqrt(e)),
    -inf where the key is masked (causal at ``q_offset``, or at or past
    ``kv_len``)."""
    from repro_torch.models.layers import _gqa_scores
    sq, sk = q.shape[1], k.shape[1]
    scores = _gqa_scores(q, k)
    scores = (scores / math.sqrt(q.shape[-1]) if scale is None
              else scores * scale)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None]
    mask = kpos < (sk if kv_len is None else kv_len)
    if causal:
        mask = mask & (qpos >= kpos)
    return scores.masked_fill(~mask, float("-inf"))


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool, q_offset: int = 0,
                            kv_len: Optional[int] = None,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradients of K2 (no window or MLA mode), step by step as K2's
    backward computes them, in f32, cast to the inputs' dtype: q (b, sq,
    h, e), o, do (b, sq, h, e_v), k (b, sk, n, e), v (b, sk, n, e_v), lse
    (b, h, sq) f32 from the forward, ``scale`` the forward's (else
    1/sqrt(e)) -> (dq, dk, dv)::

        P  = exp(S·scale - lse)        (0 where masked)
        dV = Pᵀ·dO,   dP = dO·Vᵀ,   dS = P ⊙ (dP - rowsum(dO ⊙ O))
        dQ = dS·K·scale,   dK = dSᵀ·Q·scale

    dK and dV summed over the g query heads of each kv head."""
    b, sq, h, e = q.shape
    sk, n, ev = k.shape[1], k.shape[2], v.shape[-1]
    g = h // n
    scale = 1.0 / math.sqrt(e) if scale is None else scale
    f = [t.float() for t in (q, k, v, o, do)]
    qf, kf, vf, of, dof = f
    s = _masked_scores(q, k, causal, q_offset, kv_len, scale)  # (b,n,g,q,k)
    ls = lse.float().reshape(b, n, g, sq, 1)
    p = torch.exp(s - ls)              # masked: exp(-inf) = 0
    p = torch.where(torch.isnan(p), 0.0, p)   # a row with no visible key
    do5 = dof.reshape(b, sq, n, g, ev)
    q5 = qf.reshape(b, sq, n, g, e)
    dv = torch.einsum("bngqk,bqnge->bkne", p, do5)
    dp = torch.einsum("bqnge,bkne->bngqk", do5, vf)
    delta = (dof * of).sum(-1).reshape(b, sq, n, g).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bngqk,bkne->bqnge", ds, kf).reshape(b, sq, h, e)
    dk = torch.einsum("bngqk,bqnge->bkne", ds, q5)
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def topk_retrieval_ref(queries: torch.Tensor, corpus: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 inner products, values descending, ties to the lower index (a
    stable sort keeps equal scores in index order, as jax.lax.top_k)."""
    s = queries.float() @ corpus.float().T
    vals, idxs = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idxs[:, :k].to(torch.int32)


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                    sw: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (M,K) int8, w (K,N) int8, sx (M,1), sw (1,N) -> (M,N) out_dtype:
    the int32 sums, then ``(acc·sx)·sw`` in f32.

    The sums go through a float64 product: every partial sum of int8
    products is an integer below 2**53 for K < 2**39, so any order of
    summation gives the exact int32 result, on the CPU and on the card
    (where ``torch.matmul`` has no integer path)."""
    acc = (x.double() @ w.double()).to(torch.int32)
    return (acc.float() * sx.float() * sw.float()).to(out_dtype)


def chunk_cumsum(dA: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 cumulative sum of the decays, accumulated in float64 and rounded
    once: every implementation (this one, K5, on either device) then gets
    the same f32 values whatever its order of summation.  At zamba2's
    widths the sum reaches about -3000, where one f32 step is 2.4e-4, so
    f32 sums in different orders would differ by more than the 2e-4 the
    kernel is held to."""
    return torch.cumsum(dA.double(), dim=dim).float()


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor,
                  dA: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD intra-chunk term.  x (b,nc,Q,H,P); dt/dA (b,nc,Q,H);
    B/C (b,nc,Q,H,N) (broadcast from groups to heads by the caller, as a
    view or a copy) -> (y (b,nc,Q,H,P) f32, S (b,nc,H,N,P) f32)::

        y[i] = sum_{j<=i} (C_i·B_j) exp(cs_i - cs_j) dt_j x_j
        S    = sum_j B_j ⊗ exp(cs_last - cs_j) dt_j x_j,   cs = cumsum(dA)

    The exponent is masked to -inf above the diagonal before ``exp``, so
    no positive difference is ever exponentiated."""
    dtx = x.float() * dt.float()[..., None]
    cs = chunk_cumsum(dA.float(), dim=2)                  # (b,nc,Q,H)
    Q = x.shape[2]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]    # (b,nc,Qi,Qj,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(seg.masked_fill(~mask[None, None, :, :, None],
                                  float("-inf")))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", C.float(), B.float())
    y = torch.einsum("bcqkh,bckhp->bcqhp", scores * L, dtx)
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)          # (b,nc,Q,H)
    S = torch.einsum("bcqhn,bcqhp->bchnp",
                     B.float() * decay_end[..., None], dtx)
    return y, S


def ssd_chunk_bwd_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, dA: torch.Tensor, dy: torch.Tensor,
                      dS: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`ssd_chunk_ref`, step by step as K5's
    backward computes them, in f32 (in f64 when x is f64, from the
    forward's cs, the f64 sum rounded once to f32): shapes as
    the forward's, dy (b,nc,Q,H,P) and dS (b,nc,H,N,P) the cotangents of
    y and S -> (dx, ddt, dB, dC, ddA); dx, dB, dC in the inputs' dtype
    (per head: autograd sums a group's heads), ddt and ddA f32 (f64)::

        dtx = dt·x,  s = C Bᵀ,  L = exp(cs_i - cs_j) (i >= j, else 0),
        M = s ⊙ L,  w_j = exp(cs_last - cs_j)
        dM = dy dtxᵀ,  dsc = dM ⊙ L,  G = dM ⊙ M
        d(dtx) = Mᵀ dy + w ⊙ (B dS)   ->  dx = dt·d(dtx), ddt = x·d(dtx)
        dC = dsc B,  dB = dscᵀ C + w ⊙ (dtx dSᵀ)
        dw_j = B_j·(dS dtx_j)
        ddA_k = sum_{i>=k} (rowsum_i G - colsum_i G)  +  sum_{j<k} dw_j w_j

    G's diagonal is left out of both sums (it cancels).  The reverse sum
    over rows and the forward sum of the w terms run in f64, as the
    forward's cumulative sum."""
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf, Bf, Cf = (t.to(ft) for t in (x, B, C))
    dyf, dSf, dtf = dy.to(ft), dS.to(ft), dt.to(ft)
    Q = x.shape[2]
    dtx = xf * dtf[..., None]                                # (b,nc,Q,H,P)
    cs = chunk_cumsum(dA, dim=2).to(ft)                      # (b,nc,Q,H)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (b,nc,Qi,Qj,H)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(seg.masked_fill(~lower[None, None, :, :, None],
                                  float("-inf")))
    s = torch.einsum("bcqhn,bckhn->bcqkh", Cf, Bf)
    M = s * L
    w = torch.exp(cs[:, :, -1:, :] - cs)                     # (b,nc,Q,H)
    dM = torch.einsum("bcqhp,bckhp->bcqkh", dyf, dtx)
    dsc = dM * L
    G = (dM * M).masked_fill(
        torch.eye(Q, dtype=torch.bool, device=x.device)[None, None, :, :,
                                                          None], 0.0)
    BdS = torch.einsum("bcqhn,bchnp->bcqhp", Bf, dSf)        # (B dS)_j
    ddtx = torch.einsum("bcqkh,bcqhp->bckhp", M, dyf) + w[..., None] * BdS
    dC = torch.einsum("bcqkh,bckhn->bcqhn", dsc, Bf)
    dSdtx = torch.einsum("bchnp,bcqhp->bcqhn", dSf, dtx)     # (dS dtx_j)
    dB = (torch.einsum("bcqkh,bcqhn->bckhn", dsc, Cf)
          + w[..., None] * dSdtx)
    wterm = ((Bf * dSdtx).sum(-1) * w).double()              # dw_j w_j
    rc = (G.sum(3) - G.sum(2)).double()                      # (b,nc,Q,H)
    ddA = (torch.flip(torch.cumsum(torch.flip(rc, [2]), 2), [2])
           + torch.cumsum(wterm, 2) - wterm).to(ft)
    dx = (dtf[..., None] * ddtx).to(x.dtype)
    ddt = (xf * ddtx).sum(-1)
    return dx, ddt, dB.to(B.dtype), dC.to(C.dtype), ddA
