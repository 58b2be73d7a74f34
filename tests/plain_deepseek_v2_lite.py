"""Plain float32 DeepSeek-V2(-Lite) in plain ``torch``: the forward, the
loss and (by autograd) its gradients, for the whole model or one share of
its expert layers.  No kernel, no cache, no batching across sequences; it
imports nothing of the port.  The CPU tests hold the port to it.

The configuration is a dict under the published ``config.json``'s key
names (``hidden_size``, ``kv_lora_rank``, ``n_routed_experts``,
``rope_scaling``, ...), where ``n_routed_experts`` counts the experts
held; ``expert_share`` {"router_experts", "first_expert"} gives the
router's width and the first held expert (absent: every expert held), and
``aux_loss_alpha`` the balance loss's coefficient.  The weights ``W`` are
a dict under the port's leaf names (``dense_blocks.0.mla.wq``,
``moe_blocks.3.moe.w_gate`` (E, d, ff), ...).

The model: pre-norm RMSNorm blocks; MLA with a direct query projection
(``q_lora_rank`` null), the latent ``kv_lora_rank`` normed, per-head keys
and values from it, the rope columns (one shared key head) rotated at
YaRN's blended frequencies, the softmax scaled by 1/sqrt(nope + rope)
times YaRN's mscale²; the first ``first_k_dense_replace`` layers a SwiGLU
MLP, the others a softmax router over ``router_experts`` in f32, greedy
top-k, gates not renormalised (``norm_topk_prob`` false) times
``routed_scaling_factor``, each held expert's SwiGLU on the tokens that
chose it, plus the shared experts on every token; the untied head;
next-token cross entropy over every position of the batch plus, per
expert layer, DeepSeek-V2's sequence-wise balance loss over all the
router's experts.

Departures from the published model:
- the rope rotates split halves of the 64 rope columns, where the
  published code interleaves pairs; with random weights that only
  relabels the rope columns of ``wq`` and ``wkv_a``;
- a share leaves out what the absent experts would add, as the chip that
  holds it computes it before the exchange.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def yarn_inv_freq(conf: dict) -> torch.Tensor:
    """Inverse frequencies of the rope columns, as
    ``DeepseekV2YarnRotaryEmbedding`` computes them."""
    dim, base = conf["qk_rope_head_dim"], float(conf["rope_theta"])
    extra = 1.0 / base ** (torch.arange(0, dim, 2).float() / dim)
    rs = conf.get("rope_scaling")
    if not rs:
        return extra
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(
            base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2).float() - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    return extra / rs["factor"] * ramp + extra * (1 - ramp)


def softmax_scale(conf: dict) -> float:
    scale = (conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]) ** -0.5
    rs = conf.get("rope_scaling")
    if rs and rs.get("mscale_all_dim") and rs["factor"] > 1:
        m = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
        scale *= m * m
    return scale


def rope(x, inv):
    """x (s, heads, e) rotated by split halves at positions 0..s-1."""
    ang = torch.arange(x.shape[0]).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mla(conf: dict, W, p: str, x):
    """Latent attention over one sequence x (s, d), causal."""
    s = x.shape[0]
    r, en = conf["kv_lora_rank"], conf["qk_nope_head_dim"]
    inv = yarn_inv_freq(conf)
    q = torch.einsum("sd,dhe->she", x, W[p + "wq"])
    kv = x @ W[p + "wkv_a"]
    ckv = rmsnorm(kv[:, :r], W[p + "kv_norm"], conf["rms_norm_eps"])
    k_rope = rope(kv[:, None, r:], inv)
    k_nope = torch.einsum("sr,rhe->she", ckv, W[p + "wk_b"])
    v = torch.einsum("sr,rhe->she", ckv, W[p + "wv_b"])
    h = q.shape[1]
    q = torch.cat([q[..., :en], rope(q[..., en:], inv)], -1)
    k = torch.cat([k_nope, k_rope.expand(s, h, -1)], -1)
    sc = torch.einsum("qhe,khe->hqk", q, k) * softmax_scale(conf)
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("hqk,khe->qhe", pr, v)
    return torch.einsum("qhe,hed->qd", o, W[p + "wo"])


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe(conf: dict, W, p: str, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held experts' part of the expert layer on one sequence x (s,
    d), plus the shared experts, and its balance loss."""
    share = conf.get("expert_share", {})
    first = share.get("first_expert", 0)
    E = share.get("router_experts", conf["n_routed_experts"])
    k = conf["num_experts_per_tok"]
    probs = torch.softmax(x @ W[p + "router"], -1)            # (s, E)
    gates, idx = torch.topk(probs, k, -1)
    if conf["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * conf["routed_scaling_factor"]
    y = swiglu(x, W[p + "shared_w_gate"], W[p + "shared_w_up"],
               W[p + "shared_w_down"])
    for j in range(conf["n_routed_experts"]):
        chose = idx == first + j                                # (s, k)
        rows = chose.any(-1)
        g = (gates * chose).sum(-1)[rows]
        out = swiglu(x[rows], W[p + "w_gate"][j], W[p + "w_up"][j],
                     W[p + "w_down"][j])
        y = y.index_add(0, rows.nonzero()[:, 0], g[:, None] * out)
    s = x.shape[0]
    picks = torch.zeros(E).index_add(0, idx.reshape(-1), torch.ones(s * k))
    aux = (picks * E / (s * k) * probs.mean(0)).sum() \
        * conf["aux_loss_alpha"]
    return y, aux


def block(conf: dict, W, i: int, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i`` over one sequence: (x, its balance loss)."""
    nk, eps = conf["first_k_dense_replace"], conf["rms_norm_eps"]
    p = f"dense_blocks.{i}." if i < nk else f"moe_blocks.{i - nk}."
    x = x + mla(conf, W, p + "mla.", rmsnorm(x, W[p + "ln1.scale"], eps))
    a = rmsnorm(x, W[p + "ln2.scale"], eps)
    if i < nk:
        return x + swiglu(a, W[p + "mlp.w_gate"], W[p + "mlp.w_up"],
                          W[p + "mlp.w_down"]), torch.zeros(())
    y, aux = moe(conf, W, p + "moe.", a)
    return x + y, aux


def forward(conf: dict, W, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sequence's logits (s, vocab) and its summed balance loss."""
    x = W["embed"][tokens].float()
    aux = torch.zeros(())
    for i in range(conf["num_hidden_layers"]):
        x, a = block(conf, W, i, x)
        aux = aux + a
    x = rmsnorm(x, W["final_norm.scale"], conf["rms_norm_eps"])
    return x @ W["lm_head"], aux


def loss(conf: dict, W, tokens) -> torch.Tensor:
    """Mean next-token cross entropy over every position of the batch
    (b, s), plus each expert layer's balance loss averaged over the
    sequences."""
    b, s = tokens.shape
    total = torch.zeros(())
    for r in range(b):
        logits, aux = forward(conf, W, tokens[r])
        total = total + F.cross_entropy(logits[:-1], tokens[r, 1:],
                                        reduction="sum") / (b * (s - 1)) \
            + aux / b
    return total


def loss_and_grads(conf: dict, W: Dict[str, torch.Tensor], tokens
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    P = {k: v.detach().float().requires_grad_(True) for k, v in W.items()}
    L = loss(conf, P, tokens)
    names = list(P)
    gs = torch.autograd.grad(L, [P[k] for k in names])
    return float(L.detach()), dict(zip(names, gs))
