"""Language models — port of ``repro/models/lm.py`` for all six
families.

The parameters are a :class:`DenseLM`, :class:`HybridLM`, :class:`VlmLM`,
:class:`AudioLM`, :class:`MoeLM` or :class:`XlstmLM` module whose names
mirror the JAX pytree (``embed``, ``final_norm.scale``, ``lm_head``;
dense: per layer ``blocks.<i>.{ln1,attn,ln2,mlp}.<leaf>``; hybrid: per
Mamba2 layer ``blocks.<i>.{ln,mamba}.<leaf>`` and one weight-shared
attention + MLP block ``shared``; vlm: ``groups.<g>.cross`` (a block with
cross-attention: ``ln_x``, ``xattn`` and the f32 scalar ``xgate``) and
``groups.<g>.selfs.<j>``; audio: ``encoder.blocks.<i>``,
``encoder.final_norm`` and decoder ``blocks.<i>`` with cross-attention;
moe (DeepSeek): ``dense_blocks.<i>`` then ``moe_blocks.<i>``, each
``{ln1, mla, ln2}`` and ``mlp`` or ``moe`` (MLA leaves ``wq_a``,
``q_norm``, ``wq_b`` or a direct ``wq``, ``wkv_a``, ``kv_norm``, ``wk_b``,
``wv_b``, ``wo``,
the norms' scales stored flat; MoE leaves the f32 ``router``,
``w_gate``/``w_up``/``w_down`` stacked on the expert axis and the shared
experts as ``shared_w_*``), and for v3 ``mtp`` (``proj``, ``ln``, a dense
``block``; carried, run only by the training loss); ssm (xLSTM):
``blocks.<i>`` with ``ln`` and ``mlstm`` or ``slstm``), where JAX stacks
the layers on a leading axis; ``repro_torch.bridge`` converts between the
two.  Layer stacks are Python loops over the block modules.

Caches: dense ``{"idx", "layers": {"k", "v": (L,b,S,n,e)}}``; hybrid
``{"idx", "mamba": {"ssm", "conv_x", "conv_B", "conv_C"}`` stacked on a
layer axis, ``"attn": {"k", "v": (L // attn_every, b, S, n, e)}}``, and
above ``RING_CACHE_ABOVE`` positions a sliding-window ring of ``W = 4096``
slots with ``"pos": (L // attn_every, W)`` int32 (``NEG_POS`` where
empty); vlm ``{"idx", "cross_layers", "self_layers", "cross_kv"}``; audio
``{"idx", "layers", "cross_kv"}``, ``cross_kv`` {"k", "v": (layers, b, T,
n, e)} over the T source rows, written at prefill and read at decode; moe
``{"idx", "layers": {"latent": (L, b, S, kv_lora + rope)}}``, each row
the reference's ``ckv`` then ``krope``; ssm ``{"idx", "mlstm": {"C", "n",
"m", "conv"}, "slstm": {"c", "n", "h", "m"}}``, each stacked over the
layers of its kind in layer order.  Each layer reads and writes its slice
in place, and ``idx`` is a host int so no step waits on the device to
learn it.

Training: ``init_params(..., trainable=True)`` makes every floating leaf
require a gradient (the reference differentiates every leaf; serving
keeps them frozen, so nothing there builds a graph).  ``apply``'s
"train" mode runs with grad mode as the caller has it, each block under
the reference's remat policy (:func:`_remat`); "prefill" and "decode"
run under ``torch.no_grad``.  :func:`loss_fn` is the reference's: the
next-token :func:`cross_entropy`, the MoE aux loss, and for deepseek-v3
0.3 x its MTP head's CE.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import torch_dtype
from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import SPAN_BLOCK, span
from repro_torch.kernels.ref import NEG_POS
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import options as OPT
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.sharding import constrain, embed, take_last

Cache = Dict[str, Any]
PORTED_FAMILIES = ("dense", "hybrid", "vlm", "audio", "moe", "ssm")


def _frozen(tensors: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class DenseBlock(nn.Module):
    """One pre-norm attention + MLP block; each group is a ParameterDict
    keyed like the JAX pytree, so the layer functions take it as-is.  A
    cross block adds ``ln_x``, ``xattn`` and the scalar ``xgate``."""

    def __init__(self, ln1, attn, ln2, mlp, ln_x=None, xattn=None,
                 xgate: Optional[torch.Tensor] = None):
        super().__init__()
        self.ln1, self.attn = _frozen(ln1), _frozen(attn)
        self.ln2, self.mlp = _frozen(ln2), _frozen(mlp)
        self.ln_x = None if ln_x is None else _frozen(ln_x)
        self.xattn = None if xattn is None else _frozen(xattn)
        self.xgate = (None if xgate is None
                      else nn.Parameter(xgate, requires_grad=False))


class _LM(nn.Module):
    """Embedding, final norm and (untied) head of every family."""

    def __init__(self, embed: torch.Tensor, final_norm,
                 lm_head: Optional[torch.Tensor]):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = _frozen(final_norm)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))


class DenseLM(_LM):
    def __init__(self, embed: torch.Tensor, final_norm, blocks,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__(embed, final_norm, lm_head)
        self.blocks = nn.ModuleList(blocks)


class MambaBlock(nn.Module):
    """One pre-norm Mamba2 layer of the hybrid family."""

    def __init__(self, ln, mamba):
        super().__init__()
        self.ln, self.mamba = _frozen(ln), _frozen(mamba)


class HybridLM(_LM):
    """Zamba2-style hybrid: Mamba2 layers with ONE weight-shared attention
    + MLP block applied after every ``ssm.attn_every`` of them."""

    def __init__(self, embed: torch.Tensor, final_norm, blocks,
                 shared: DenseBlock, lm_head: Optional[torch.Tensor] = None):
        super().__init__(embed, final_norm, lm_head)
        self.blocks = nn.ModuleList(blocks)
        self.shared = shared


class VlmGroup(nn.Module):
    """One cross block (self- then cross-attention over the image) and
    ``cross_attn_every - 1`` self blocks."""

    def __init__(self, cross: DenseBlock, selfs):
        super().__init__()
        self.cross = cross
        self.selfs = nn.ModuleList(selfs)


class VlmLM(_LM):
    """Llama-3.2-Vision-style: groups of one cross block and self
    blocks; the image enters as precomputed patch embeddings."""

    def __init__(self, embed: torch.Tensor, final_norm, groups,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__(embed, final_norm, lm_head)
        self.groups = nn.ModuleList(groups)


class Encoder(nn.Module):
    def __init__(self, blocks, final_norm):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)


class AudioLM(_LM):
    """Whisper-style encoder-decoder: a non-causal encoder over the audio
    frames, decoder blocks with cross-attention over its output."""

    def __init__(self, embed: torch.Tensor, final_norm, encoder: Encoder,
                 blocks, lm_head: Optional[torch.Tensor] = None):
        super().__init__(embed, final_norm, lm_head)
        self.encoder = encoder
        self.blocks = nn.ModuleList(blocks)


class MoEBlock(nn.Module):
    """DeepSeek block: pre-norm MLA, then a dense gated MLP (the first
    ``first_k_dense`` layers, and the MTP head) or the MoE FFN."""

    def __init__(self, ln1, mla, ln2, mlp=None, moe=None):
        super().__init__()
        self.ln1, self.mla, self.ln2 = _frozen(ln1), _frozen(mla), \
            _frozen(ln2)
        self.mlp = None if mlp is None else _frozen(mlp)
        self.moe = None if moe is None else _frozen(moe)


class MTP(nn.Module):
    """DeepSeek-v3's multi-token-prediction head: ``proj (2d, d)``,
    ``ln`` and a dense :class:`MoEBlock`."""

    def __init__(self, proj: torch.Tensor, ln, block: MoEBlock):
        super().__init__()
        self.proj = nn.Parameter(proj, requires_grad=False)
        self.ln = _frozen(ln)
        self.block = block


class MoeLM(_LM):
    def __init__(self, embed: torch.Tensor, final_norm, dense_blocks,
                 moe_blocks, lm_head: Optional[torch.Tensor] = None,
                 mtp: Optional[MTP] = None):
        super().__init__(embed, final_norm, lm_head)
        self.dense_blocks = nn.ModuleList(dense_blocks)
        self.moe_blocks = nn.ModuleList(moe_blocks)
        self.mtp = mtp


class XlstmBlock(nn.Module):
    """One pre-norm xLSTM layer: an mLSTM or an sLSTM."""

    def __init__(self, ln, mlstm=None, slstm=None):
        super().__init__()
        self.ln = _frozen(ln)
        self.mlstm = None if mlstm is None else _frozen(mlstm)
        self.slstm = None if slstm is None else _frozen(slstm)


class XlstmLM(_LM):
    def __init__(self, embed: torch.Tensor, final_norm, blocks,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__(embed, final_norm, lm_head)
        self.blocks = nn.ModuleList(blocks)


LM = Union[DenseLM, HybridLM, VlmLM, AudioLM, MoeLM, XlstmLM]


def set_trainable(model: nn.Module, trainable: bool) -> nn.Module:
    """Every floating leaf requires a gradient (``trainable``) or none
    does; -> the model."""
    for p in model.parameters():
        p.requires_grad_(trainable and p.is_floating_point())
    return model


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(PORTED_FAMILIES)})")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, device: torch.device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(cfg.d_model, dtype=torch.float32,
                                device=device)}


def init_dense_block(cfg: ModelConfig, generator: torch.Generator,
                     device: torch.device, cross: bool = False) -> DenseBlock:
    d, h, n = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    e, f = cfg.resolved_head_dim, cfg.d_ff
    dt = torch_dtype(cfg.dtype)

    def dense(shape, scale=None):
        return L.dense_init(shape, dt, generator, device, scale)

    def attention(bias):
        p = {"wq": dense((d, h, e)), "wk": dense((d, n, e)),
             "wv": dense((d, n, e)),
             "wo": dense((h, e, d), scale=(h * e) ** -0.5)}
        if bias:
            p.update(
                bq=torch.zeros((h, e), dtype=dt, device=device),
                bk=torch.zeros((n, e), dtype=dt, device=device),
                bv=torch.zeros((n, e), dtype=dt, device=device))
        return p

    mlp = {"w_up": dense((d, f)), "w_down": dense((f, d))}
    if cfg.gated_mlp:
        mlp["w_gate"] = dense((d, f))
    extra = {}
    if cross:
        extra = dict(ln_x=_norm(cfg, device), xattn=attention(False),
                     xgate=torch.zeros((), dtype=torch.float32,
                                       device=device))
    return DenseBlock(_norm(cfg, device), attention(cfg.qkv_bias),
                      _norm(cfg, device), mlp, **extra)


def init_moe_block(cfg: ModelConfig, generator: torch.Generator,
                   device: torch.device, dense_ffn: bool) -> MoEBlock:
    d, dt = cfg.d_model, torch_dtype(cfg.dtype)
    mla = MLA.init_mla(d, cfg.num_heads, cfg.mla, dt, generator, device)
    if not dense_ffn:
        return MoEBlock(_norm(cfg, device), mla, _norm(cfg, device),
                        moe=MOE.init_moe(d, cfg.moe, dt, generator, device,
                                         OPT.router_width(cfg)))
    f = cfg.moe.dense_d_ff
    mlp = {k: L.dense_init(shape, dt, generator, device)
           for k, shape in (("w_up", (d, f)), ("w_down", (f, d)),
                            ("w_gate", (d, f)))}
    return MoEBlock(_norm(cfg, device), mla, _norm(cfg, device), mlp=mlp)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device, trainable: bool = False) -> LM:
    """Random weights with the JAX package's distributions, drawn on
    ``device`` from ``generator``; ``trainable``: every leaf requires a
    gradient."""
    return set_trainable(_init_params(cfg, generator, device), trainable)


def _init_params(cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device) -> LM:
    require_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    d, V = cfg.d_model, cfg.vocab_size
    embed = L.embed_init((V, d), dt, generator, device)
    lm_head = (None if cfg.tie_embeddings
               else L.dense_init((d, V), dt, generator, device))
    final_norm = _norm(cfg, device)

    def dense_blocks(n, cross=False):
        return [init_dense_block(cfg, generator, device, cross)
                for _ in range(n)]

    if cfg.family == "hybrid":
        blocks = [MambaBlock(_norm(cfg, device),
                             SSM.init_mamba2(d, cfg.ssm, dt, generator,
                                             device))
                  for _ in range(cfg.num_layers)]
        shared = init_dense_block(cfg, generator, device)
        return HybridLM(embed, final_norm, blocks, shared, lm_head)
    if cfg.family == "vlm":
        every = cfg.vlm.cross_attn_every
        groups = [VlmGroup(init_dense_block(cfg, generator, device, True),
                           dense_blocks(every - 1))
                  for _ in range(cfg.num_layers // every)]
        return VlmLM(embed, final_norm, groups, lm_head)
    if cfg.family == "audio":
        encoder = Encoder(dense_blocks(cfg.encdec.encoder_layers),
                          _norm(cfg, device))
        return AudioLM(embed, final_norm, encoder,
                       dense_blocks(cfg.num_layers, cross=True), lm_head)
    if cfg.family == "moe":
        nk = cfg.moe.first_k_dense
        mtp = None
        if cfg.mtp_depth:
            mtp = MTP(L.dense_init((2 * d, d), dt, generator, device),
                      _norm(cfg, device),
                      init_moe_block(cfg, generator, device, True))
        return MoeLM(
            embed, final_norm,
            [init_moe_block(cfg, generator, device, True)
             for _ in range(nk)],
            [init_moe_block(cfg, generator, device, False)
             for _ in range(cfg.num_layers - nk)], lm_head, mtp)
    if cfg.family == "ssm":
        blocks = [XlstmBlock(_norm(cfg, device), slstm=XL.init_slstm(
                      d, dt, generator, device))
                  if i in cfg.ssm.slstm_layers else
                  XlstmBlock(_norm(cfg, device), mlstm=XL.init_mlstm(
                      d, cfg.ssm, dt, generator, device))
                  for i in range(cfg.num_layers)]
        return XlstmLM(embed, final_norm, blocks, lm_head)
    return DenseLM(embed, final_norm, dense_blocks(cfg.num_layers), lm_head)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

RING_CACHE_ABOVE = 32768    # lm._window_for: a hybrid model's ring cache
RING_WINDOW = 4096


def window_for(cfg: ModelConfig, max_len: int) -> int:
    """Sliding window (ring slots) of a sub-quadratic hybrid model at long
    context; 0 otherwise."""
    if (cfg.subquadratic and cfg.family == "hybrid"
            and max_len > RING_CACHE_ABOVE):
        return RING_WINDOW
    return 0


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Cache:
    require_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    n, e = cfg.num_kv_heads, cfg.resolved_head_dim

    def kv(n_layers, length):
        shape = (n_layers, batch, length, n, e)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    fam = cfg.family
    if fam == "dense":
        return {"idx": 0, "layers": kv(cfg.num_layers, max_len)}
    if fam == "vlm":
        every = cfg.vlm.cross_attn_every
        n_groups = cfg.num_layers // every
        return {"idx": 0, "cross_layers": kv(n_groups, max_len),
                "self_layers": kv(n_groups * (every - 1), max_len),
                "cross_kv": kv(n_groups, cfg.vlm.vision_tokens)}
    if fam == "audio":
        return {"idx": 0, "layers": kv(cfg.num_layers, max_len),
                "cross_kv": kv(cfg.num_layers, cfg.encdec.source_positions)}
    if fam == "moe":
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return {"idx": 0, "layers": {"latent": torch.zeros(
            (cfg.num_layers, batch, max_len, width), dtype=dt,
            device=device)}}
    if fam == "ssm":
        ms = [XL.init_mlstm_state(batch, cfg.d_model, cfg.ssm, dt, device)
              for i in range(cfg.num_layers)
              if i not in cfg.ssm.slstm_layers]
        ss = [XL.init_slstm_state(batch, cfg.d_model, device)
              for i in range(cfg.num_layers) if i in cfg.ssm.slstm_layers]
        cache = {"idx": 0, "mlstm": _stack_states(ms)}
        if ss:
            cache["slstm"] = _stack_states(ss)
        return cache
    W = window_for(cfg, max_len)
    n_attn = cfg.num_layers // cfg.ssm.attn_every
    attn = kv(n_attn, W or max_len)
    if W:
        attn["pos"] = torch.full((n_attn, W), NEG_POS, dtype=torch.int32,
                                 device=device)
    states = [SSM.init_mamba2_state(batch, cfg.d_model, cfg.ssm, dt, device)
              for _ in range(cfg.num_layers)]
    return {"idx": 0,
            "mamba": {k: torch.stack([st[k] for st in states])
                      for k in states[0]},
            "attn": attn}


def _stack_states(states: List[Dict[str, torch.Tensor]]):
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _layer(tree: Optional[Mapping[str, torch.Tensor]],
           i: int) -> Optional[Dict[str, torch.Tensor]]:
    """Layer ``i``'s slice (views) of a cache stacked on a layer axis."""
    return None if tree is None else {k: v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

_aten = torch.ops.aten


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of products
    with no batch dimension (``mm``, ``addmm``, and ``bmm`` over a batch
    of 1, which ``einsum`` issues for such a product), recompute the rest
    (K2 included)."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig, mode: str):
    """The reference's ``_remat`` with ``torch.utils.checkpoint`` around a
    block: in "train" mode with grad on, "none" keeps everything, "dots"
    keeps only :func:`_save_dots`' outputs, any other policy ("full")
    recomputes the block in the backward.  Remat changes memory, never
    values.  In "train" mode the block runs in an ``lm.block`` span
    (``core/spans.py``), inside the checkpointed function, so a recompute
    records it again."""
    if mode != "train":
        return fn

    def block(*args, **kwargs):
        with span(SPAN_BLOCK):
            return fn(*args, **kwargs)
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return block
    context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _save_dots)
               if cfg.remat == "dots" else ckpt.noop_context_fn)

    def run(*args, **kwargs):
        return ckpt.checkpoint(block, *args, use_reentrant=False,
                               context_fn=context, **kwargs)
    return run


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def dense_block(p: DenseBlock, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor, causal: bool = True,
                cache: Optional[Mapping[str, torch.Tensor]] = None,
                cache_idx: Optional[int] = None, window: int = 0,
                cross_kv: Optional[torch.Tensor] = None,
                cross_cache: Optional[Mapping[str, torch.Tensor]] = None):
    """Returns (x, cache, cross): the cache is updated in place; a cross
    block attends over ``cross_cache`` {"k", "v"} if given, else over
    k/v projected from the source ``cross_kv`` (b, T, d), which it returns
    as ``cross`` for the caller to store."""
    h, new_cache = _attend(p.attn, cfg, L.rmsnorm(p.ln1, x, cfg.norm_eps),
                           positions=positions, causal=causal, cache=cache,
                           cache_idx=cache_idx, window=window)
    x = constrain(x + h, ("batch", None, None))
    new_cross = None
    if p.xattn is not None and (cross_kv is not None
                                or cross_cache is not None):
        if cross_cache is not None:
            new_cross = cross_cache
        else:
            new_cross = {"k": L.project_heads(cross_kv, p.xattn["wk"]),
                         "v": L.project_heads(cross_kv, p.xattn["wv"])}
        h, _ = L.attention(p.xattn, L.rmsnorm(p.ln_x, x, cfg.norm_eps),
                           positions=positions, theta=cfg.rope_theta,
                           kv_override=(new_cross["k"], new_cross["v"]))
        x = x + torch.tanh(p.xgate).to(x.dtype) * h
    x = constrain(x + L.mlp(p.mlp, L.rmsnorm(p.ln2, x, cfg.norm_eps)),
                  ("batch", None, None))
    return x, new_cache, new_cross


def _attend(p, cfg: ModelConfig, x, *, positions, causal, cache, cache_idx,
            window):
    """Dense attention, or over a ring cache (one with ``"pos"``): the
    chunk's k/v and positions are written at slots ``(idx + i) % W`` first,
    then every slot is attended under its position and the window, as the
    reference does (a chunk may overwrite slots an earlier query of the
    same chunk would still have seen)."""
    if cache is None or "pos" not in cache:
        return L.attention(p, x, positions=positions, theta=cfg.rope_theta,
                           causal=causal, cache=cache, cache_idx=cache_idx,
                           window=window)
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    W, s = kc.shape[1], x.shape[1]
    if s > W:
        raise ValueError(f"a chunk of {s} tokens is longer than the "
                         f"{W}-slot ring: it would write a slot twice")
    q, k, v = L.project_qkv(p, x, positions, cfg.rope_theta)
    start = cache_idx % W
    n1 = min(s, W - start)      # slots up to the end of the ring, then 0..
    for dst, src in ((kc, k), (vc, v)):
        dst[:, start:start + n1] = src[:, :n1].to(dst.dtype)
        dst[:, :s - n1] = src[:, n1:].to(dst.dtype)
    pc[start:start + n1] = positions[:n1].to(torch.int32)
    pc[:s - n1] = positions[n1:].to(torch.int32)
    out = L.attend_cache(q, kc, vc, cache_idx, kv_positions=pc,
                         window=window)
    return L.project_out(p, out, x.dtype), cache


def _run_dense_stack(blocks: nn.ModuleList, cfg: ModelConfig,
                     x: torch.Tensor, positions: torch.Tensor,
                     caches: Optional[Mapping[str, torch.Tensor]],
                     cache_idx: Optional[int],
                     mode: str = "train") -> torch.Tensor:
    """Loop over the layer modules; layer ``i`` uses ``caches[...][i]``,
    written in place."""
    block = _remat(dense_block, cfg, mode)
    for i, blk in enumerate(blocks):
        x, _, _ = block(blk, cfg, x, positions=positions,
                        cache=_layer(caches, i), cache_idx=cache_idx)
    return x


def _mamba_layer(blk: MambaBlock, cfg: ModelConfig, x: torch.Tensor,
                 states: Optional[Mapping[str, torch.Tensor]],
                 i: int) -> torch.Tensor:
    """Layer ``i``: x + mamba2(rmsnorm(x)); with a cache, its state slice
    ``states[...][i]`` is read and overwritten in place."""
    st = _layer(states, i)
    y, new = SSM.mamba2_forward(blk.mamba, L.rmsnorm(blk.ln, x, cfg.norm_eps),
                                cfg.ssm, init_state=st,
                                return_state=st is not None)
    if st is not None:
        for k, v in new.items():
            st[k].copy_(v)
    return x + y


def _run_hybrid(params: HybridLM, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Cache],
                cache_idx: Optional[int], mode: str) -> torch.Tensor:
    """Groups of ``attn_every`` Mamba2 layers, each followed by the shared
    block with its own cache slice (a ring's window is its slot count),
    then the ``num_layers % attn_every`` tail layers.  Remat wraps each
    Mamba2 layer and each pass of the shared block (the reference also
    wraps each group around its layers': memory only)."""
    mamba_layer = _remat(_mamba_layer, cfg, mode)
    block = _remat(dense_block, cfg, mode)
    every = cfg.ssm.attn_every
    n_groups = cfg.num_layers // every
    states = None if cache is None else cache["mamba"]
    attn = None if cache is None else cache["attn"]
    W = attn["k"].shape[2] if attn is not None and "pos" in attn else 0
    for g in range(n_groups):
        for i in range(g * every, (g + 1) * every):
            x = mamba_layer(params.blocks[i], cfg, x, states, i)
        x, _, _ = block(params.shared, cfg, x, positions=positions,
                        cache=_layer(attn, g), cache_idx=cache_idx,
                        window=W)
    for i in range(n_groups * every, cfg.num_layers):
        x = mamba_layer(params.blocks[i], cfg, x, states, i)
    return x


def _stack_cross(crosses: List[Optional[Dict[str, torch.Tensor]]]):
    """Per-layer cross k/v -> {"k", "v"} stacked on a layer axis, or None
    where no layer had a source (as the reference's scan output)."""
    if any(c is None for c in crosses):
        return None
    return {k: torch.stack([c[k] for c in crosses]) for k in ("k", "v")}


def _run_vlm(params: VlmLM, cfg: ModelConfig, batch, x, positions, cache,
             cache_idx, mode, new_cache):
    vision = batch.get("vision_embeds")
    if vision is None and cache is None:
        vision = torch.zeros((x.shape[0], cfg.vlm.vision_tokens,
                              cfg.vlm.vision_dim), dtype=x.dtype,
                             device=x.device)
    xkv = None if cache is None or mode == "prefill" else cache["cross_kv"]
    per_group = cfg.vlm.cross_attn_every - 1

    def group(grp, x, gi):
        """One cross block, then the group's self blocks; -> (x, cross)."""
        x, _, nx = dense_block(
            grp.cross, cfg, x, positions=positions,
            cache=None if cache is None else _layer(cache["cross_layers"],
                                                    gi),
            cache_idx=cache_idx, cross_kv=vision,
            cross_cache=_layer(xkv, gi))
        for j, blk in enumerate(grp.selfs):
            x, _, _ = dense_block(
                blk, cfg, x, positions=positions,
                cache=None if cache is None else _layer(
                    cache["self_layers"], gi * per_group + j),
                cache_idx=cache_idx)
        return x, nx

    group = _remat(group, cfg, mode)
    crosses = []
    for gi, grp in enumerate(params.groups):
        x, nx = group(grp, x, gi)
        crosses.append(nx)
    if new_cache is not None and mode == "prefill":
        new_cache["cross_kv"] = _stack_cross(crosses)
    return x


def _run_audio(params: AudioLM, cfg: ModelConfig, batch, x, positions,
               cache, cache_idx, mode, new_cache):
    frames = batch.get("audio_frames")
    if frames is None and cache is None:
        frames = torch.zeros((x.shape[0], cfg.encdec.source_positions,
                              cfg.d_model), dtype=x.dtype, device=x.device)
    block = _remat(dense_block, cfg, mode)
    memory = None
    if frames is not None:          # the encoder: train, or prefill
        enc_pos = torch.arange(frames.shape[1], device=x.device)
        mem = frames
        for blk in params.encoder.blocks:
            mem, _, _ = block(blk, cfg, mem, positions=enc_pos,
                              causal=False)
        memory = L.rmsnorm(params.encoder.final_norm, mem, cfg.norm_eps)
    xkv = (cache["cross_kv"] if cache is not None and mode == "decode"
           else None)
    crosses = []
    for i, blk in enumerate(params.blocks):
        x, _, nx = block(
            blk, cfg, x, positions=positions,
            cache=None if cache is None else _layer(cache["layers"], i),
            cache_idx=cache_idx, cross_kv=memory, cross_cache=_layer(xkv, i))
        crosses.append(nx)
    if new_cache is not None and mode == "prefill":
        new_cache["cross_kv"] = _stack_cross(crosses)
    return x


def moe_block(p: MoEBlock, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Optional[Mapping[str, torch.Tensor]] = None,
              cache_idx: Optional[int] = None,
              capacity_factor: float = 1.25, layer: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux): MLA (its latent cache written in place), then the
    dense MLP (aux 0) or the MoE FFN and its load-balance loss: with
    dropless routing (``models/options.py``) the layer's held experts'
    part, ``layer`` naming it in ``moe.EXPERT_ROWS``, else the capacity
    path at ``capacity_factor``."""
    inv_freq, scale = OPT.mla_rope(cfg, x.device)
    h, _ = MLA.mla_attention(p.mla, L.rmsnorm(p.ln1, x, cfg.norm_eps),
                             cfg.mla, positions=positions,
                             theta=cfg.rope_theta, cache=cache,
                             cache_idx=cache_idx, inv_freq=inv_freq,
                             scale=scale)
    # as dense_block's: a partial sum over "model" left to DTensor is
    # reduced onto the sequence (an uneven split of v3's 4,095 MTP rows)
    x = constrain(x + h, ("batch", None, None))
    h2 = L.rmsnorm(p.ln2, x, cfg.norm_eps)
    routing = OPT.routing_of(cfg)
    if p.moe is not None and routing.dropless:
        y, aux = MOE.moe_ffn_dropless(p.moe, h2, cfg.moe, routing, layer)
    elif p.moe is not None:
        y, aux = MOE.moe_ffn(p.moe, h2, cfg.moe,
                             capacity_factor=capacity_factor)
    else:
        y = L.mlp(p.mlp, h2)
        aux = torch.zeros((), device=x.device)
    return constrain(x + y, ("batch", None, None)), aux


def _run_moe(params: MoeLM, cfg: ModelConfig, x, positions, cache,
             cache_idx, mode) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense blocks, then the MoE blocks, layer ``i`` on slice ``i``
    of the latent cache; the capacity factor is 2.0 below 4096 tokens a
    call, else 1.25 (the reference's; dropless routing has none)."""
    cap = 2.0 if x.shape[0] * x.shape[1] < 4096 else 1.25
    lat = None if cache is None else cache["layers"]
    aux = torch.zeros((), device=x.device)
    block = _remat(moe_block, cfg, mode)
    for i, blk in enumerate([*params.dense_blocks, *params.moe_blocks]):
        x, a = block(blk, cfg, x, positions=positions,
                     cache=_layer(lat, i), cache_idx=cache_idx,
                     capacity_factor=cap, layer=i)
        aux = aux + a
    return x, aux


def _run_xlstm(params: XlstmLM, cfg: ModelConfig, x: torch.Tensor,
               cache: Optional[Cache]) -> torch.Tensor:
    """Each layer x + block(rmsnorm(x)); with a cache, its state slice
    (the i-th of its kind) is read and overwritten in place."""
    counts = {"mlstm": 0, "slstm": 0}
    for blk in params.blocks:
        kind = "slstm" if blk.slstm is not None else "mlstm"
        st = None if cache is None else _layer(cache[kind], counts[kind])
        counts[kind] += 1
        h = L.rmsnorm(blk.ln, x, cfg.norm_eps)
        if kind == "slstm":
            y, new = XL.slstm_forward(blk.slstm, h, init_state=st,
                                      return_state=st is not None)
        else:
            y, new = XL.mlstm_forward(blk.mlstm, h, cfg.ssm, init_state=st,
                                      return_state=st is not None)
        if st is not None:
            for k, v in new.items():
                st[k].copy_(v)
        x = x + y
    return x


def _logits(params: LM, x: torch.Tensor) -> torch.Tensor:
    if params.lm_head is not None:
        return constrain(x @ params.lm_head, ("batch", None, "model"))
    # tied embeddings: scale logits by 1/sqrt(d) (the table is unit-scale)
    return constrain((x @ params.embed.T) * (x.shape[-1] ** -0.5),
                     ("batch", None, "model"))


def apply(params: LM, cfg: ModelConfig, batch: Mapping[str, Any], *,
          mode: str = "train", cache: Optional[Cache] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Cache]]:
    """Returns (logits, aux_loss, new_cache): aux_loss is the MoE
    layers' summed load-balance loss (0 for the other families).

    batch: {"tokens": (b, s)} [+ "vision_embeds" (b, T, vision_dim) /
    "audio_frames" (b, T, d)].  mode: "train" (no cache; a graph where the
    parameters require a gradient and grad mode is on) | "prefill" (fills
    the cache; a vlm/audio prefill stores the source's cross k/v) |
    "decode" (a vlm/audio decode reads them); both under no_grad."""
    require_ported(cfg)
    serving = mode != "train"
    with torch.no_grad() if serving else contextlib.nullcontext():
        return _apply(params, cfg, batch, mode, cache)


def _apply(params: LM, cfg: ModelConfig, batch: Mapping[str, Any],
           mode: str, cache: Optional[Cache]):
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = constrain(embed(tokens, params.embed), ("batch", None, None))
    cache_idx = cache["idx"] if cache is not None else None
    positions = torch.arange(s, device=tokens.device) + (cache_idx or 0)
    new_cache = None if cache is None else {**cache, "idx": cache_idx + s}
    aux = torch.zeros((), device=tokens.device)
    fam = cfg.family
    if fam == "moe":
        x, aux = _run_moe(params, cfg, x, positions, cache, cache_idx,
                          mode)
    elif fam == "ssm":
        x = _run_xlstm(params, cfg, x, cache)
    elif fam == "hybrid":
        x = _run_hybrid(params, cfg, x, positions, cache, cache_idx, mode)
    elif fam == "vlm":
        x = _run_vlm(params, cfg, batch, x, positions, cache, cache_idx,
                     mode, new_cache)
    elif fam == "audio":
        x = _run_audio(params, cfg, batch, x, positions, cache, cache_idx,
                       mode, new_cache)
    else:
        x = _run_dense_stack(params.blocks, cfg, x, positions,
                             None if cache is None else cache["layers"],
                             cache_idx, mode)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = _logits(params, x)
    return logits, aux, new_cache


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's CE: in f32, the row max's gradient stopped, the mean
    over every (b, s) position.  The gold logit is gathered (the reference
    contracts a one-hot, the same value)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    gold = take_last(shifted, labels[..., None].long())[..., 0] + m[..., 0]
    return (lse - gold).mean()


def loss_fn(params: LM, cfg: ModelConfig, batch: Mapping[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, {"ce", "aux"[, "mtp_ce"]}): the next-token CE plus the
    MoE aux loss, and with deepseek-v3's MTP head (``cfg.mtp_depth`` and
    ``params.mtp``) 0.3 x the CE of its prediction of the token after
    next, as ``repro/models/lm.py::loss_fn``."""
    logits, aux, _ = apply(params, cfg, batch, mode="train")
    labels = batch["labels"]
    ce = cross_entropy(logits[:, :-1], labels[:, 1:])
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    mtp = getattr(params, "mtp", None)
    if cfg.mtp_depth and mtp is not None:
        tokens = batch["tokens"]
        h = embed(tokens[:, 1:], params.embed)
        h0 = L.rmsnorm(mtp.ln, embed(tokens[:, :-1], params.embed),
                       cfg.norm_eps)
        # rows over the batch axes, d whole, as mla._latent's and why
        h = constrain(torch.cat([h0, h], dim=-1) @ mtp.proj,
                      ("batch", None, None))
        pos = torch.arange(h.shape[1], device=h.device)
        h, _ = moe_block(mtp.block, cfg, h, positions=pos)
        mtp_ce = cross_entropy(_logits(params, h)[:, :-1], labels[:, 2:])
        loss = loss + 0.3 * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics
