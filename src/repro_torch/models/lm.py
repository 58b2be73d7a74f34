"""Dense-family language model — port of the dense path of
``repro/models/lm.py``.

The parameters are an :class:`DenseLM` module whose names mirror the JAX
pytree (``embed``, ``final_norm.scale``, ``lm_head``, and per layer
``blocks.<i>.{ln1,attn,ln2,mlp}.<leaf>``, where JAX stacks the layers on a
leading axis); ``repro_torch.bridge`` converts between the two.  The layer
stack is a Python loop over the block modules.

The dense cache is ``{"idx": int, "layers": {"k", "v": (L,b,S,n,e)}}``;
layer ``l`` reads and writes the view ``layers["k"][l]`` in place, and
``idx`` is a host int so no step waits on the device to learn it.

Other families (moe, hybrid, ssm, vlm, audio) raise NotImplementedError,
as do the ring cache and the training loss: later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Cache = Dict[str, Any]


def _frozen(tensors: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class DenseBlock(nn.Module):
    """One pre-norm attention + MLP block; each group is a ParameterDict
    keyed like the JAX pytree, so the layer functions take it as-is."""

    def __init__(self, ln1, attn, ln2, mlp):
        super().__init__()
        self.ln1, self.attn = _frozen(ln1), _frozen(attn)
        self.ln2, self.mlp = _frozen(ln2), _frozen(mlp)


class DenseLM(nn.Module):
    def __init__(self, embed: torch.Tensor, final_norm, blocks,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = _frozen(final_norm)
        self.blocks = nn.ModuleList(blocks)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_dense_block(cfg: ModelConfig, generator: torch.Generator,
                     device: torch.device) -> DenseBlock:
    d, h, n = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    e, f = cfg.resolved_head_dim, cfg.d_ff
    dt = torch_dtype(cfg.dtype)

    def dense(shape, scale=None):
        return L.dense_init(shape, dt, generator, device, scale)

    def ones():
        return {"scale": torch.ones(d, dtype=torch.float32, device=device)}

    attn = {"wq": dense((d, h, e)), "wk": dense((d, n, e)),
            "wv": dense((d, n, e)),
            "wo": dense((h, e, d), scale=(h * e) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(
            bq=torch.zeros((h, e), dtype=dt, device=device),
            bk=torch.zeros((n, e), dtype=dt, device=device),
            bv=torch.zeros((n, e), dtype=dt, device=device))
    mlp = {"w_up": dense((d, f)), "w_down": dense((f, d))}
    if cfg.gated_mlp:
        mlp["w_gate"] = dense((d, f))
    return DenseBlock(ones(), attn, ones(), mlp)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> DenseLM:
    """Random weights with the JAX package's distributions, drawn on
    ``device`` from ``generator``."""
    _require_dense(cfg)
    dt = torch_dtype(cfg.dtype)
    d, V = cfg.d_model, cfg.vocab_size
    embed = L.embed_init((V, d), dt, generator, device)
    lm_head = (None if cfg.tie_embeddings
               else L.dense_init((d, V), dt, generator, device))
    blocks = [init_dense_block(cfg, generator, device)
              for _ in range(cfg.num_layers)]
    final_norm = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    return DenseLM(embed, final_norm, blocks, lm_head)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Cache:
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"idx": 0,
            "layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def dense_block(p: DenseBlock, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, causal: bool = True,
                cache: Optional[Mapping[str, torch.Tensor]] = None,
                cache_idx: Optional[int] = None, window: int = 0):
    """Returns (x, cache); the cache is updated in place."""
    h, new_cache = _attend(p.attn, cfg, L.rmsnorm(p.ln1, x, cfg.norm_eps),
                           positions=positions, causal=causal, cache=cache,
                           cache_idx=cache_idx, window=window)
    x = x + h
    x = x + L.mlp(p.mlp, L.rmsnorm(p.ln2, x, cfg.norm_eps))
    return x, new_cache


def _attend(p, cfg: ModelConfig, x, *, positions, causal, cache, cache_idx,
            window):
    if cache is not None and "pos" in cache:
        raise NotImplementedError(
            "ring (sliding-window) caches come with the hybrid family port")
    return L.attention(p, x, positions=positions, theta=cfg.rope_theta,
                       causal=causal, cache=cache, cache_idx=cache_idx,
                       window=window)


def _run_dense_stack(blocks: nn.ModuleList, cfg: ModelConfig,
                     x: torch.Tensor, positions: torch.Tensor,
                     caches: Optional[Mapping[str, torch.Tensor]],
                     cache_idx: Optional[int], *, causal: bool = True):
    """Loop over the layer modules; layer ``i`` uses ``caches[...][i]``."""
    for i, blk in enumerate(blocks):
        c = (None if caches is None else
             {"k": caches["k"][i], "v": caches["v"][i]})
        x, _ = dense_block(blk, cfg, x, positions=positions, causal=causal,
                           cache=c, cache_idx=cache_idx)
    return x, caches


def _logits(params: DenseLM, x: torch.Tensor) -> torch.Tensor:
    if params.lm_head is not None:
        return x @ params.lm_head
    # tied embeddings: scale logits by 1/sqrt(d) (the table is unit-scale)
    return (x @ params.embed.T) * (x.shape[-1] ** -0.5)


@torch.no_grad()
def apply(params: DenseLM, cfg: ModelConfig, batch: Mapping[str, Any], *,
          mode: str = "train", cache: Optional[Cache] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Returns (logits, aux_loss, new_cache).  batch: {"tokens": (b, s)}.
    ``mode`` is kept for the reference's signature; only the presence of a
    cache changes what runs."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = F.embedding(tokens, params.embed)
    cache_idx = cache["idx"] if cache is not None else None
    positions = torch.arange(s, device=tokens.device) + (cache_idx or 0)
    x, lc = _run_dense_stack(params.blocks, cfg, x, positions,
                             None if cache is None else cache["layers"],
                             cache_idx)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = _logits(params, x)
    new_cache = (None if cache is None
                 else {**cache, "layers": lc, "idx": cache_idx + s})
    return logits, torch.zeros((), device=tokens.device), new_cache
