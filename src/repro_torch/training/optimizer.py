"""AdamW and gradient utilities — port of ``repro/training/optimizer.py``.

Plain functions on tensors that repeat the reference's arithmetic (not
``torch.optim.AdamW``): the global-norm clip in f32, moments kept in f32
and stored in ``state_dtype`` (bf16 halves optimizer memory), bias
corrections from ``step`` as f32, weight decay on every leaf, the warm-up
and cosine schedule with its 0.1 floor, each update cast back to the
parameter's dtype.  Everything stays on the parameters' device, ``step``
included, so an update never waits for the device.

Where the reference returns new pytrees, the port updates in place: the
parameters (an ``nn.Module``) and the moments ``m`` and ``v``
(``{name: tensor}`` in ``named_parameters`` order); ``step`` is a new
0-d int32 tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Tuple

import torch
from torch import nn

from repro_torch import torch_dtype

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the parameters' device
    m: Tensors
    v: Tensors


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # "bfloat16" halves optimizer memory
    warmup_steps: int = 100
    total_steps: int = 10_000


def adamw_init(params: nn.Module, cfg: AdamWConfig) -> AdamWState:
    dt = torch_dtype(cfg.state_dtype)
    named = list(params.named_parameters())
    device = named[0][1].device

    def zeros():
        return {k: torch.zeros_like(p, dtype=dt) for k, p in named}
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      zeros(), zeros())


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: nn.Module, cfg: AdamWConfig
                 ) -> Tuple[nn.Module, AdamWState, Dict[str, torch.Tensor]]:
    """One step from ``grads`` ({name: tensor}, every parameter's):
    updates ``params`` and the moments in place -> (params, new state,
    {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for name, p in params.named_parameters():
        m, v = state.m[name], state.v[name]
        g = grads[name].float() * scale
        m1 = b1 * m.float() + (1 - b1) * g
        v1 = b2 * v.float() + (1 - b2) * torch.square(g)
        mh, vh = m1 / bc1, v1 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m1.to(m.dtype))
        v.copy_(v1.to(v.dtype))
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
