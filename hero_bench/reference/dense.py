"""Plain float32 forward and loss of a dense (Qwen3-style GQA) model as
the port runs it: pre-norm RMSNorm blocks, split-half RoPE, causal GQA
attention with a softmax in f32, SwiGLU, tied logits scaled by
hidden_size**-0.5, next-token cross entropy averaged over every
position of the batch.  Departures from the published model are listed
in its configuration file.  The loss is taken one batch row at a time,
each layer recomputed in the backward, so that a row of a long sequence
fits beside the model's f32 state."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hero_bench.reference.precision import mm


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x (s, heads, e) rotated by split halves at positions ``pos``."""
    e = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, e, 2, dtype=torch.float32,
                                        device=x.device) / e))
    ang = pos[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _heads(x, w, precision):
    """x (s, d) . w (d, n, e) -> (s, n, e)."""
    d, n, e = w.shape
    return mm(x, w.reshape(d, n * e), precision).reshape(-1, n, e)


def block(m: dict, W: Dict[str, torch.Tensor], i: int, x: torch.Tensor,
          precision: str = "f32") -> torch.Tensor:
    """Layer ``i`` over one sequence's hidden states x (s, d)."""
    p = f"blocks.{i}."
    s = x.shape[0]
    pos = torch.arange(s, device=x.device)
    h, n, e = (m["num_attention_heads"], m["num_key_value_heads"],
               m["head_dim"])
    eps, theta = m["rms_norm_eps"], float(m["rope_theta"])
    a = _rmsnorm(x, W[p + "ln1.scale"], eps)
    q = _rope(_heads(a, W[p + "attn.wq"], precision), pos, theta)
    k = _rope(_heads(a, W[p + "attn.wk"], precision), pos, theta)
    v = _heads(a, W[p + "attn.wv"], precision)
    qg = q.reshape(s, n, h // n, e)
    sc = torch.einsum("qnge,kne->ngqk", qg, k) / math.sqrt(e)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("ngqk,kne->qnge", pr, v).reshape(s, h * e)
    x = x + mm(o, W[p + "attn.wo"].reshape(h * e, -1), precision)
    a = _rmsnorm(x, W[p + "ln2.scale"], eps)
    up = mm(a, W[p + "mlp.w_up"], precision)
    gate = mm(a, W[p + "mlp.w_gate"], precision)
    return x + mm(F.silu(gate) * up, W[p + "mlp.w_down"], precision)


def row_loss(m: dict, W: Dict[str, torch.Tensor], tokens: torch.Tensor,
             precision: str = "f32") -> torch.Tensor:
    """Summed next-token cross entropy of one sequence (s,)."""
    x = W["embed"][tokens].float()
    for i in range(m["num_hidden_layers"]):
        x = checkpoint(block, m, W, i, x, precision, use_reentrant=False)
    x = _rmsnorm(x, W["final_norm.scale"], m["rms_norm_eps"])
    lg = mm(x, W["embed"].T, precision) * m["hidden_size"] ** -0.5
    return F.cross_entropy(lg[:-1], tokens[1:], reduction="sum")


def loss_and_grads(m: dict, W: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, precision: str = "f32"
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean cross entropy over every position of the batch (b, s) and
    its gradient by leaf, summed a row at a time."""
    b, s = tokens.shape
    names = list(W)
    total = 0.0
    grads = {k: torch.zeros_like(W[k]) for k in names}
    for r in range(b):
        L = row_loss(m, W, tokens[r], precision) / (b * (s - 1))
        gs = torch.autograd.grad(L, [W[k] for k in names])
        for k, g in zip(names, gs):
            grads[k].add_(g)
        total += float(L.detach())
        del gs
    return total, grads
