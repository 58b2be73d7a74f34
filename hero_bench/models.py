"""The weights the benchmark makes for both sides: drawn on the device
from the seed in one call per dtype, scaled leaf by leaf as the model
family says (``families/<family>.py``'s ``init_scale``), then handed to
the program as views and read again by the plain reference."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch import nn


Scale = Callable[[str, Tuple[int, ...]], float]


class Weights:
    """Every leaf of one model as a view of one buffer per dtype, drawn
    in one call each from ``seed`` on ``device``; ``scale(leaf, shape)``
    gives the normal's scale of a leaf, 0 for ones."""

    def __init__(self, shapes: List[Tuple[str, Tuple[int, ...], torch.dtype]],
                 seed: int, device: torch.device, scale: Scale):
        self.shapes = shapes
        self.scale = scale
        self.seed = seed
        self.device = device
        self.tensors = self._draw()

    def _draw(self) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        out: Dict[str, torch.Tensor] = {}
        for dt in sorted({s[2] for s in self.shapes}, key=str):
            leaves = [s for s in self.shapes if s[2] == dt]
            total = sum(_numel(s[1]) for s in leaves)
            buf = torch.randn(total, generator=g, device=self.device,
                              dtype=dt)
            buf.clamp_(-2.0, 2.0)
            off = 0
            for name, shape, _ in leaves:
                n = _numel(shape)
                view = buf[off:off + n].view(shape)
                scale = self.scale(name, shape)
                if scale == 0.0:
                    view.fill_(1.0)
                elif scale != 1.0:
                    view.mul_(scale)
                out[name] = view
                off += n
        return out

    def redraw(self) -> Dict[str, torch.Tensor]:
        """The same weights again (the generator is deterministic)."""
        return self._draw()


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def program_model(cfg, seed: int, device: torch.device, scale: Scale,
                  trainable: bool = False) -> Tuple[nn.Module, Weights]:
    """The program's parameter module for ``cfg`` with the benchmark's
    weights: the structure from ``lm.init_params`` on the meta device,
    every leaf replaced by a view of the benchmark's buffers."""
    from repro_torch.models import lm
    meta = lm.init_params(cfg, torch.Generator(), torch.device("meta"))
    shapes = [(n, tuple(p.shape), p.dtype)
              for n, p in meta.named_parameters()]
    w = Weights(shapes, seed, device, scale)
    for name, t in w.tensors.items():
        owner, leaf = _owner(meta, name)
        param = nn.Parameter(t, requires_grad=trainable
                             and t.is_floating_point())
        if isinstance(owner, nn.ParameterDict):
            owner[leaf] = param
        else:
            setattr(owner, leaf, param)
    return meta, w


def _owner(module: nn.Module, name: str):
    parts = name.split(".")
    for p in parts[:-1]:
        module = getattr(module, p) if not p.isdigit() else module[int(p)]
    return module, parts[-1]
