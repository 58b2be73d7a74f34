"""Language models — port of the dense and hybrid paths of
``repro/models/lm.py``.

The parameters are a :class:`DenseLM` or :class:`HybridLM` module whose
names mirror the JAX pytree (``embed``, ``final_norm.scale``, ``lm_head``;
dense: per layer ``blocks.<i>.{ln1,attn,ln2,mlp}.<leaf>``; hybrid: per
Mamba2 layer ``blocks.<i>.{ln,mamba}.<leaf>`` and one weight-shared
attention + MLP block ``shared``), where JAX stacks the layers on a leading
axis; ``repro_torch.bridge`` converts between the two.  Layer stacks are
Python loops over the block modules.

Caches: dense ``{"idx", "layers": {"k", "v": (L,b,S,n,e)}}``; hybrid
``{"idx", "mamba": {"ssm", "conv_x", "conv_B", "conv_C"}`` stacked on a
layer axis, ``"attn": {"k", "v": (L // attn_every, b, S, n, e)}}``.  Each
layer reads and writes its slice in place, and ``idx`` is a host int so no
step waits on the device to learn it.

The moe, ssm (xLSTM), vlm and audio families raise NotImplementedError,
as do the hybrid family's sliding-window ring cache (above 32768
positions) and the training loss: later slices (ROADMAP).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

Cache = Dict[str, Any]
PORTED_FAMILIES = ("dense", "hybrid")


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


class MambaBlock(nn.Module):
    """One pre-norm Mamba2 layer of the hybrid family."""

    def __init__(self, ln, mamba):
        super().__init__()
        self.ln, self.mamba = _frozen(ln), _frozen(mamba)


class HybridLM(nn.Module):
    """Zamba2-style hybrid: Mamba2 layers with ONE weight-shared attention
    + MLP block applied after every ``ssm.attn_every`` of them."""

    def __init__(self, embed: torch.Tensor, final_norm, blocks,
                 shared: DenseBlock, lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = _frozen(final_norm)
        self.blocks = nn.ModuleList(blocks)
        self.shared = shared
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))


LM = Union[DenseLM, HybridLM]


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(PORTED_FAMILIES)})")


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
                device: torch.device) -> LM:
    """Random weights with the JAX package's distributions, drawn on
    ``device`` from ``generator``."""
    require_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    d, V = cfg.d_model, cfg.vocab_size
    embed = L.embed_init((V, d), dt, generator, device)
    lm_head = (None if cfg.tie_embeddings
               else L.dense_init((d, V), dt, generator, device))
    final_norm = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.family == "hybrid":
        blocks = [MambaBlock(
            {"scale": torch.ones(d, dtype=torch.float32, device=device)},
            SSM.init_mamba2(d, cfg.ssm, dt, generator, device))
            for _ in range(cfg.num_layers)]
        shared = init_dense_block(cfg, generator, device)
        return HybridLM(embed, final_norm, blocks, shared, lm_head)
    blocks = [init_dense_block(cfg, generator, device)
              for _ in range(cfg.num_layers)]
    return DenseLM(embed, final_norm, blocks, lm_head)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

RING_CACHE_ABOVE = 32768    # lm._window_for: a hybrid model's ring cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Cache:
    require_ported(cfg)
    dt = torch_dtype(cfg.dtype)

    def attn_cache(n_layers):
        shape = (n_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    if cfg.family == "dense":
        return {"idx": 0, "layers": attn_cache(cfg.num_layers)}
    if cfg.subquadratic and max_len > RING_CACHE_ABOVE:
        raise NotImplementedError(
            f"a hybrid cache above {RING_CACHE_ABOVE} positions is a "
            f"sliding-window ring cache, not ported yet (ROADMAP Queue 1: "
            f"ring cache with a windowed K1/K2)")
    states = [SSM.init_mamba2_state(batch, cfg.d_model, cfg.ssm, dt, device)
              for _ in range(cfg.num_layers)]
    return {"idx": 0,
            "mamba": {k: torch.stack([st[k] for st in states])
                      for k in states[0]},
            "attn": attn_cache(cfg.num_layers // cfg.ssm.attn_every)}


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
            "ring (sliding-window) caches are not ported yet (ROADMAP "
            "Queue 1: ring cache with a windowed K1/K2)")
    return L.attention(p, x, positions=positions, theta=cfg.rope_theta,
                       causal=causal, cache=cache, cache_idx=cache_idx,
                       window=window)


def _run_dense_stack(blocks: nn.ModuleList, cfg: ModelConfig,
                     x: torch.Tensor, positions: torch.Tensor,
                     caches: Optional[Mapping[str, torch.Tensor]],
                     cache_idx: Optional[int], *,
                     causal: bool = True) -> torch.Tensor:
    """Loop over the layer modules; layer ``i`` uses ``caches[...][i]``,
    written in place."""
    for i, blk in enumerate(blocks):
        c = (None if caches is None else
             {"k": caches["k"][i], "v": caches["v"][i]})
        x, _ = dense_block(blk, cfg, x, positions=positions, causal=causal,
                           cache=c, cache_idx=cache_idx)
    return x


def _mamba_layer(blk: MambaBlock, cfg: ModelConfig, x: torch.Tensor,
                 states: Optional[Mapping[str, torch.Tensor]],
                 i: int) -> torch.Tensor:
    """Layer ``i``: x + mamba2(rmsnorm(x)); with a cache, its state slice
    ``states[...][i]`` is read and overwritten in place."""
    st = None if states is None else {k: v[i] for k, v in states.items()}
    y, new = SSM.mamba2_forward(blk.mamba, L.rmsnorm(blk.ln, x, cfg.norm_eps),
                                cfg.ssm, init_state=st,
                                return_state=st is not None)
    if st is not None:
        for k, v in new.items():
            st[k].copy_(v)
    return x + y


def _run_hybrid(params: HybridLM, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Cache],
                cache_idx: Optional[int]) -> torch.Tensor:
    """Groups of ``attn_every`` Mamba2 layers, each followed by the shared
    block with its own cache slice, then the ``num_layers % attn_every``
    tail layers."""
    every = cfg.ssm.attn_every
    n_groups = cfg.num_layers // every
    states = None if cache is None else cache["mamba"]
    attn = None if cache is None else cache["attn"]
    for g in range(n_groups):
        for i in range(g * every, (g + 1) * every):
            x = _mamba_layer(params.blocks[i], cfg, x, states, i)
        c = None if attn is None else {"k": attn["k"][g], "v": attn["v"][g]}
        x, _ = dense_block(params.shared, cfg, x, positions=positions,
                           cache=c, cache_idx=cache_idx)
    for i in range(n_groups * every, cfg.num_layers):
        x = _mamba_layer(params.blocks[i], cfg, x, states, i)
    return x


def _logits(params: LM, x: torch.Tensor) -> torch.Tensor:
    if params.lm_head is not None:
        return x @ params.lm_head
    # tied embeddings: scale logits by 1/sqrt(d) (the table is unit-scale)
    return (x @ params.embed.T) * (x.shape[-1] ** -0.5)


@torch.no_grad()
def apply(params: LM, cfg: ModelConfig, batch: Mapping[str, Any], *,
          mode: str = "train", cache: Optional[Cache] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Returns (logits, aux_loss, new_cache).  batch: {"tokens": (b, s)}.
    ``mode`` is kept for the reference's signature; only the presence of a
    cache changes what runs."""
    require_ported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = F.embedding(tokens, params.embed)
    cache_idx = cache["idx"] if cache is not None else None
    positions = torch.arange(s, device=tokens.device) + (cache_idx or 0)
    if cfg.family == "hybrid":
        x = _run_hybrid(params, cfg, x, positions, cache, cache_idx)
    else:
        x = _run_dense_stack(params.blocks, cfg, x, positions,
                             None if cache is None else cache["layers"],
                             cache_idx)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = _logits(params, x)
    new_cache = None if cache is None else {**cache, "idx": cache_idx + s}
    return logits, torch.zeros((), device=tokens.device), new_cache
