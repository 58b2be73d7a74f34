"""Plain float32 forward and loss of a DeepSeek-V2-style model (latent
attention, a leading dense layer, routed and shared experts) as the
configuration file states it, for one chip's share of each expert layer:
the benchmark's copy of the repository's plain reference
(``tests/plain_deepseek_v2_lite.py``), its products through
``reference.precision.mm`` and computed in blocks so that a 4 x 8192
batch fits on one card beside AdamW's f32 state.

MLA with a direct query projection (``q_lora_rank`` null): the latent
normed, per-head keys and values from it, the rope columns (one shared
key head) rotated by split halves at YaRN's blended frequencies, the
softmax scaled by 1/sqrt(nope + rope) x YaRN's mscale²; the first
``first_k_dense_replace`` layers a SwiGLU MLP, the others a softmax
router over ``expert_share.router_experts`` in f32, greedy top-k, gates
not renormalised (``norm_topk_prob`` false) x ``routed_scaling_factor``,
each held expert's SwiGLU over the tokens that chose it (what the absent
experts add is left out, as on the chip before the exchange), the shared
experts on every token; the untied head; the mean next-token cross
entropy plus each expert layer's sequence-wise balance loss
(``aux_loss_alpha``), averaged over the sequences.  Departures from the
published model are listed in the configuration file.

Blocks: one sequence at a time, each layer recomputed in the backward,
attention by query blocks of ``Q_BLOCK`` rows over the keys they see,
each recomputed too; gradients accumulate into the leaves' ``.grad``."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hero_bench.reference.precision import mm

Q_BLOCK = 1024


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def inv_freq(m: dict, device) -> torch.Tensor:
    """YaRN's inverse frequencies of the rope columns (DeepSeek's
    ``DeepseekV2YarnRotaryEmbedding``)."""
    dim, base = m["qk_rope_head_dim"], float(m["rope_theta"])
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim)
    rs = m.get("rope_scaling")
    if not rs:
        return extra
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(
            base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low if high > low else 0.001)).clamp(0, 1)
    return extra / rs["factor"] * ramp + extra * (1 - ramp)


def softmax_scale(m: dict) -> float:
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    rs = m.get("rope_scaling")
    if rs and rs.get("mscale_all_dim") and rs["factor"] > 1:
        f = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
        scale *= f * f
    return scale


def _rope(x, inv):
    """x (s, heads, e) rotated by split halves at positions 0..s-1."""
    ang = torch.arange(x.shape[0], device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _heads(x, w, precision):
    """x (s, r) . w (r, n, e) -> (s, n, e)."""
    r, n, e = w.shape
    return mm(x, w.reshape(r, n * e), precision).reshape(-1, n, e)


def _attend(q, k, v, q0: int, scale: float):
    """Causal attention of the queries q (rows q0.., h, e) over the keys
    k, v (0..q0 + rows, h, ·)."""
    rows = q.shape[0]
    sc = torch.einsum("qhe,khe->hqk", q, k) * scale
    mask = (torch.arange(k.shape[0], device=q.device)[None]
            <= torch.arange(q0, q0 + rows, device=q.device)[:, None])
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,khe->qhe", pr, v)


def mla(m: dict, W, p: str, x, precision: str):
    s = x.shape[0]
    r, en = m["kv_lora_rank"], m["qk_nope_head_dim"]
    inv = inv_freq(m, x.device)
    q = _heads(x, W[p + "wq"], precision)
    kv = mm(x, W[p + "wkv_a"], precision)
    ckv = _rmsnorm(kv[:, :r], W[p + "kv_norm"], m["rms_norm_eps"])
    k_rope = _rope(kv[:, None, r:], inv)
    k_nope = _heads(ckv, W[p + "wk_b"], precision)
    v = _heads(ckv, W[p + "wv_b"], precision)
    h = q.shape[1]
    q = torch.cat([q[..., :en], _rope(q[..., en:], inv)], -1)
    k = torch.cat([k_nope, k_rope.expand(s, h, -1)], -1)
    scale = softmax_scale(m)
    o = torch.cat([checkpoint(_attend, q[i:i + Q_BLOCK], k[:i + Q_BLOCK],
                              v[:i + Q_BLOCK], i, scale, use_reentrant=False)
                   for i in range(0, s, Q_BLOCK)])
    wo = W[p + "wo"]
    return mm(o.reshape(s, -1), wo.reshape(-1, wo.shape[-1]), precision)


def _swiglu(x, gate, up, down, precision):
    return mm(F.silu(mm(x, gate, precision)) * mm(x, up, precision), down,
              precision)


def moe(m: dict, W, p: str, x, precision: str
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held experts' part of the expert layer over one sequence x (s,
    d), the shared experts', and the layer's balance loss."""
    share = m["expert_share"]
    first, E = share["first_expert"], share["router_experts"]
    k = m["num_experts_per_tok"]
    probs = torch.softmax(mm(x, W[p + "router"], precision), -1)
    gates, idx = torch.topk(probs, k, -1)
    if m["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * m["routed_scaling_factor"]
    y = _swiglu(x, W[p + "shared_w_gate"], W[p + "shared_w_up"],
                W[p + "shared_w_down"], precision)
    for j in range(m["n_routed_experts"]):
        chose = idx == first + j
        rows = chose.any(-1).nonzero()[:, 0]
        g = (gates * chose).sum(-1)[rows]
        out = _swiglu(x[rows], W[p + "w_gate"][j], W[p + "w_up"][j],
                      W[p + "w_down"][j], precision)
        y = y.index_add(0, rows, g[:, None] * out)
    s = x.shape[0]
    picks = torch.zeros(E, device=x.device).index_add(
        0, idx.reshape(-1), torch.ones(s * k, device=x.device))
    aux = (picks * E / (s * k) * probs.mean(0)).sum() * m["aux_loss_alpha"]
    return y, aux


def block(m: dict, W, i: int, x, precision: str = "f32"):
    """Layer ``i`` over one sequence x (s, d) -> (x, balance loss)."""
    nk, eps = m["first_k_dense_replace"], m["rms_norm_eps"]
    p = f"dense_blocks.{i}." if i < nk else f"moe_blocks.{i - nk}."
    x = x + mla(m, W, p + "mla.", _rmsnorm(x, W[p + "ln1.scale"], eps),
                precision)
    a = _rmsnorm(x, W[p + "ln2.scale"], eps)
    if i < nk:
        return x + _swiglu(a, W[p + "mlp.w_gate"], W[p + "mlp.w_up"],
                           W[p + "mlp.w_down"], precision), \
            torch.zeros((), device=x.device)
    y, aux = moe(m, W, p + "moe.", a, precision)
    return x + y, aux


def row_loss(m: dict, W, tokens, precision: str = "f32") -> torch.Tensor:
    """Summed next-token cross entropy of one sequence (s,), and its
    summed balance loss."""
    x = W["embed"][tokens].float()
    aux = torch.zeros((), device=x.device)
    for i in range(m["num_hidden_layers"]):
        x, a = checkpoint(block, m, W, i, x, precision, use_reentrant=False)
        aux = aux + a
    x = _rmsnorm(x, W["final_norm.scale"], m["rms_norm_eps"])
    lg = mm(x, W["lm_head"], precision)
    return F.cross_entropy(lg[:-1], tokens[1:], reduction="sum"), aux


def loss_and_grads(m: dict, W: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, precision: str = "f32"
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean cross entropy over every position of the batch (b, s) plus
    the balance losses averaged over the sequences, and its gradient by
    leaf, summed a row at a time into each leaf's ``.grad`` (a leaf of
    ``W`` that does not require one is taken as an f32 copy that does)."""
    b, s = tokens.shape
    P = {k: (v if v.requires_grad else
             v.detach().float().requires_grad_(True)) for k, v in W.items()}
    total = 0.0
    for r in range(b):
        ce, aux = row_loss(m, P, tokens[r], precision)
        L = ce / (b * (s - 1)) + aux / b
        L.backward()
        total += float(L.detach())
    grads = {}
    for k, v in P.items():
        grads[k] = v.grad if v.grad is not None else torch.zeros_like(v)
        v.grad = None
    return total, grads
