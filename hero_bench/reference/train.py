"""Plain float32 AdamW steps as the configuration states them: a global
norm clip, f32 moments, bias corrections, decoupled weight decay on
every leaf, the warm-up and cosine schedule with its 0.1 floor, each
update cast to the leaf's stated dtype and back."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

LossAndGrads = Callable[[Dict[str, torch.Tensor], torch.Tensor],
                        tuple]


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi
                                                              * prog)))


def train_steps(loss_and_grads: LossAndGrads,
                init: Dict[str, torch.Tensor], batches: List[torch.Tensor],
                opt: dict,
                sample: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """``len(batches)`` AdamW steps from ``init`` (the leaves in their
    stated dtypes) -> {"losses", "first_grad": {leaf: norm of the clipped
    gradient of step 1}, "change": {leaf: norm of the change after the
    last step}}; with ``sample`` ({leaf: flat indices}) also
    "first_sample": {leaf: those entries of the first clipped gradient,
    on the host}."""
    P = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in init.items()}
    dtypes = {k: v.dtype for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    out: dict = {"losses": [], "first_grad": {}, "first_sample": {}}
    b1, b2 = opt["b1"], opt["b2"]
    for step, toks in enumerate(batches, start=1):
        L, grads = loss_and_grads(P, toks)
        out["losses"].append(L)
        with torch.no_grad():
            gn = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            sc = min(opt["grad_clip"] / max(float(gn), 1e-9), 1.0)
            lr = lr_at(opt, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for name, p in P.items():
                g = grads[name].mul_(sc)
                if step == 1:
                    out["first_grad"][name] = float(g.norm())
                    if sample is not None:
                        out["first_sample"][name] = g.reshape(-1)[
                            sample[name].to(g.device)].cpu()
                m[name].mul_(b1).add_(g, alpha=1 - b1)
                v2[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m[name] / bc1) / (torch.sqrt(v2[name] / bc2)
                                           + opt["eps"]) \
                    + opt["weight_decay"] * p
                p.copy_((p - lr * delta).to(dtypes[name]).float())
        del grads
    with torch.no_grad():
        out["change"] = {k: float((P[k] - init[k].float()).norm())
                         for k in P}
    return out
