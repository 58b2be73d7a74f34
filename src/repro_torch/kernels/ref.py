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
