"""Multi-head Latent Attention (DeepSeek v2/v3) — port of
``repro/models/mla.py``.

The forward without a cache uses the *naive* form: per-head K/V
materialised from the latent, q·k over ``qk_nope + qk_rope`` (192) and
values of ``v_head_dim`` (128), as MHA (n = h) through K2's MLA mode.
With a cache (every prefill chunk and decode step) it uses the *absorbed*
form: ``wk_b`` folds into the query (``q_lat``, ``kv_lora_rank`` wide),
which attends over the cached latent rows ``[ckv | krope]`` (576) with the
latent ``ckv`` (512) as values, all heads over one latent row (n = 1, g =
h): K2's MLA mode for a chunk (causal at ``q_offset = idx``), K1's for a
single token; ``wv_b`` is applied after.  Both scale by ``scale``
(1/sqrt(qk_head_dim) unless given: YaRN multiplies it by mscale², and
rotates the rope columns at its blended frequencies ``inv_freq``;
``models/options.py``).  ``q_lora_rank`` 0 (the published ``null``) is a
direct query projection ``wq (d, h, qk_head_dim)`` in place of ``wq_a``,
``q_norm`` and ``wq_b``.

The cache is one buffer ``latent (b, S, kv_lora_rank + qk_rope_head_dim)``
per layer, so a key row is one contiguous read and the values are a view
of its first columns; the reference's ``{"ckv", "krope"}`` are its two
column ranges (``repro_torch.bridge`` maps between them).  It is written
in place at ``idx``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm
from repro_torch.models.sharding import constrain

Params = Mapping[str, torch.Tensor]


def init_mla(d: int, n_heads: int, m: MLAConfig, dtype: torch.dtype,
             generator: torch.Generator,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """Random weights with the reference's distributions and names."""
    def dense(shape, scale=None):
        return dense_init(shape, dtype, generator, device, scale)

    def norm(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    if m.q_lora_rank:
        q = {"wq_a": dense((d, m.q_lora_rank)),
             "q_norm": norm(m.q_lora_rank),
             "wq_b": dense((m.q_lora_rank, n_heads, m.qk_head_dim))}
    else:
        q = {"wq": dense((d, n_heads, m.qk_head_dim))}
    return {
        **q,
        "wkv_a": dense((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": norm(m.kv_lora_rank),
        "wk_b": dense((m.kv_lora_rank, n_heads, m.qk_nope_head_dim)),
        "wv_b": dense((m.kv_lora_rank, n_heads, m.v_head_dim)),
        "wo": dense((n_heads, m.v_head_dim, d),
                    scale=(n_heads * m.v_head_dim) ** -0.5),
    }


def _latent(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (b,s,d) @ w (d,r): a down-projection, its rows over the batch
    axes and r whole under an activation mesh, as the reference's
    (data, None) weight gives it.  Left to DTensor, r splits over "model"
    and the rmsnorm's backward splits the sequence over it instead, whose
    (b·s) views cost DTensor's redistribute planner a graph search an op."""
    return constrain(x @ w, ("batch", None, None))


def _project_q(p: Params, x: torch.Tensor, m: MLAConfig, positions,
               theta: float, inv_freq=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> q_nope (b,s,h,e_n), q_rope (b,s,h,e_r)."""
    if "wq" in p:
        q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    else:
        ql = rmsnorm({"scale": p["q_norm"]}, _latent(x, p["wq_a"]))
        q = torch.einsum("bsr,rhe->bshe", ql, p["wq_b"])
    q = constrain(q, ("batch", None, "model", None))
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions, theta,
                        inv_freq)
    return q_nope, q_rope


def _project_kv_latent(p: Params, x: torch.Tensor, m: MLAConfig, positions,
                       theta: float, inv_freq=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ckv (b,s,r), k_rope (b,s,e_r): what gets cached."""
    kv = _latent(x, p["wkv_a"])
    ckv = rmsnorm({"scale": p["kv_norm"]}, kv[..., :m.kv_lora_rank])
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions, theta,
                        inv_freq)
    return ckv, k_rope[..., 0, :]


def mla_attention(p: Params, x: torch.Tensor, m: MLAConfig, *,
                  positions: torch.Tensor, theta: float,
                  cache: Optional[Mapping[str, torch.Tensor]] = None,
                  cache_idx: Optional[int] = None,
                  inv_freq: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor,
                             Optional[Mapping[str, torch.Tensor]]]:
    """x (b,s,d) -> (y (b,s,d), cache).  ``cache`` {"latent": (b,S,r+e_r)}
    is written in place at ``cache_idx`` (a host int) and returned."""
    dtype = x.dtype
    b, s, _ = x.shape
    h = p["wo"].shape[0]
    r = m.kv_lora_rank
    scale = m.qk_head_dim ** -0.5 if scale is None else scale
    q_nope, q_rope = _project_q(p, x, m, positions, theta, inv_freq)
    ckv, k_rope = _project_kv_latent(p, x, m, positions, theta, inv_freq)

    if cache is None:
        # naive (compute-optimal) form: MHA over per-head K/V
        k_nope = torch.einsum("bsr,rhe->bshe", ckv, p["wk_b"])
        v = torch.einsum("bsr,rhe->bshe", ckv, p["wv_b"])
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            b, s, h, m.qk_rope_head_dim)], dim=-1)
        out = ops.flash_attention(q, k, v, causal=True, scale=scale)
    else:
        # absorbed (memory-optimal) form over the latent cache
        lat = cache["latent"]
        valid = cache_idx + s
        if valid > lat.shape[1]:
            raise ValueError(f"cache overflow: {valid} > {lat.shape[1]} "
                             f"positions")
        lat[:, cache_idx:valid, :r] = ckv.to(lat.dtype)
        lat[:, cache_idx:valid, r:] = k_rope.to(lat.dtype)
        q_lat = torch.einsum("bqhe,rhe->bqhr", q_nope, p["wk_b"])
        qa = torch.cat([q_lat, q_rope.to(q_lat.dtype)], dim=-1)
        keys = lat[:, :valid, None]                  # (b, valid, 1, r+e_r)
        if s > 1:
            out_lat = ops.flash_attention(qa, keys, keys[..., :r],
                                          causal=True, q_offset=cache_idx,
                                          scale=scale)
        else:
            lengths = torch.full((b,), valid, dtype=torch.int32,
                                 device=x.device)
            out_lat = ops.decode_attention(qa[:, 0], keys, keys[..., :r],
                                           lengths, scale=scale)[:, None]
        out = torch.einsum("bqhr,rhe->bqhe", out_lat.to(dtype), p["wv_b"])
    y = torch.einsum("bqhe,hed->bqd", out.to(dtype), p["wo"])
    return y, cache


def init_cache_mla(batch: int, max_len: int, m: MLAConfig,
                   dtype: torch.dtype,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    return {"latent": torch.zeros(
        (batch, max_len, m.kv_lora_rank + m.qk_rope_head_dim), dtype=dtype,
        device=device)}
