"""Mixture-of-Experts with capacity-based scatter dispatch (GShard-style)
— port of ``repro/models/moe.py``.

A softmax router in f32 picks the top-k experts of each token and
renormalises their gates; each assignment takes the next slot of its
expert's queue, in the flattened (token, choice) order, and one whose slot
is past the capacity ``C`` is dropped (the token keeps its residual).
Tokens are scattered into an ``(E, C, d)`` buffer, run through the
batched expert FFN (``torch.bmm``: a plain product that the JAX package
leaves to XLA, outside any Pallas kernel) and gathered back weighted by
their gates; shared experts see every token.  Like the reference, every
call runs all E experts over their C slots, so it reads every expert's
weights.  Returns the switch-style load-balance loss as well.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.sharding import constrain

Params = Mapping[str, torch.Tensor]


def init_moe(d: int, cfg: MoEConfig, dtype: torch.dtype,
             generator: torch.Generator,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """Random weights with the reference's distributions; the shared
    experts' leaves are ``shared_w_gate``, ``shared_w_up`` and
    ``shared_w_down`` (the reference's ``shared: {w_gate, w_up,
    w_down}``)."""
    E, ff = cfg.num_experts, cfg.d_ff

    def dense(shape, dt=dtype):
        return dense_init(shape, dt, generator, device)

    p = {"router": dense((d, E), torch.float32),
         "w_gate": dense((E, d, ff)), "w_up": dense((E, d, ff)),
         "w_down": dense((E, ff, d))}
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        p.update(shared_w_gate=dense((d, sff)), shared_w_up=dense((d, sff)),
                 shared_w_down=dense((sff, d)))
    return p


def _router(p: Params, x2: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 (T, d) -> gates (T, k) in x2's dtype, idx (T, k), aux (scalar)."""
    probs = torch.softmax(x2.float() @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    E = cfg.num_experts
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_loss
    return gates.to(x2.dtype), idx, aux


def capacity(T: int, cfg: MoEConfig, capacity_factor: float) -> int:
    """Slots per expert: ``T·k·cf / E`` rounded up, at least 8, rounded up
    to a multiple of 8 (the reference's static shape)."""
    C = int(max(8, -(-int(T * cfg.top_k * capacity_factor)
                     // cfg.num_experts)))
    return -(-C // 8) * 8


def dispatch(idx: torch.Tensor, E: int, C: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx (T, k) -> (slot, keep) per flattened assignment: its position
    in its expert's queue (an exclusive running count in (token, choice)
    order) and whether that is below C."""
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    slot = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
    return slot, slot < C


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig, *,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    T, E, k = b * s, cfg.num_experts, cfg.top_k
    x2 = x.reshape(T, d)
    gates, idx, aux = _router(p, x2, cfg)
    C = capacity(T, cfg, capacity_factor)
    flat_e, flat_g = idx.reshape(-1), gates.reshape(-1)
    slot, keep = dispatch(idx, E, C)
    src = torch.arange(T, device=x.device).repeat_interleave(k)

    # the kept assignments into their (expert, slot), each pair unique; a
    # dropped one adds 0 at slot 0, as the reference's scatter-add does
    # (no mask selects the kept ones, so no shape depends on the data)
    slot_c = torch.where(keep, slot, 0)
    upd = torch.where(keep[:, None], x2[src], 0)
    grouped = x.new_zeros((E, C, d)).index_put_((flat_e, slot_c), upd,
                                                accumulate=True)
    # decode (few tokens): d over "data" keeps the expert weights
    # stationary; prefill and train keep d whole (the reference's layout)
    grouped = constrain(grouped, ("model", None, "data") if T <= 4096
                        else ("model", None, None))

    act = F.silu(torch.bmm(grouped, p["w_gate"])) * torch.bmm(grouped,
                                                              p["w_up"])
    out_g = torch.bmm(act, p["w_down"])                        # (E, C, d)

    # gather back with gate weighting: token t's k rows are contiguous
    picked = out_g[flat_e, slot_c]
    picked = torch.where(keep[:, None], picked, 0) * flat_g[:, None]
    y = picked.reshape(T, k, d).sum(1)

    if "shared_w_gate" in p:
        h = F.silu(x2 @ p["shared_w_gate"]) * (x2 @ p["shared_w_up"])
        y = y + h @ p["shared_w_down"]
    return y.reshape(b, s, d), aux
