"""The comparison that decides ``correct``: what the timed path produced,
judged against the plain reference after the window has closed (the
program's state freed first), each number beside its limit.

Train cells: each of the first three steps' loss; the first gradient as
the optimizer got it (read back from AdamW's first moment after one
step): the norm of each leaf, and the norm of its difference from the
reference's over a sample of each leaf's entries drawn from the seed;
the norm of each leaf's change after the three steps.  By the worst
leaf (and the median one), over the larger of the reference's norm of
that leaf and the median leaf's.  Leaves whose reference gradient is
under a thousandth of the median leaf's are left out of the change and
of the gradient's difference."""
from __future__ import annotations

import gc
import statistics
from pathlib import Path
from typing import Dict, List, Optional

import torch

from hero_bench import registry
from hero_bench.reference.precision import strict_f32
from hero_bench.reference.train import train_steps

SAMPLE = 1 << 16          # entries of each leaf's first gradient compared


def _free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample_indices(numels: Dict[str, int], seed: int
                   ) -> Dict[str, torch.Tensor]:
    """Flat indices of each leaf's compared entries: all of a small
    leaf, ``SAMPLE`` drawn from (seed, leaf's position) of a larger."""
    out = {}
    for i, (name, n) in enumerate(numels.items()):
        if n <= SAMPLE:
            out[name] = torch.arange(n)
        else:
            g = torch.Generator().manual_seed(
                (seed * 1_000_003 + i) % (2 ** 63))
            out[name] = torch.randint(n, (SAMPLE,), generator=g)
    return out


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[List[str]] = None) -> float:
    """Worst leaf's |prog - ref| over max(ref, median leaf's ref)."""
    names = keep if keep is not None else list(ref)
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def moving_leaves(first_grad: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move under AdamW by round-off alone)."""
    med = statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Each side: {"losses", "first_grad", "first_sample", "change"}."""
    keep = moving_leaves(ref["first_grad"])
    losses = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                      ref["losses"]))
    norms = {k: float(ref["first_sample"][k].norm()) for k in keep}
    med = statistics.median(norms.values())
    errs = sorted(float((prog["first_sample"][k].float()
                         - ref["first_sample"][k].float()).norm())
                  / max(norms[k], med, 1e-30) for k in keep)
    return {"loss_gap": losses,
            "first_grad_gap": leaf_gap(prog["first_grad"],
                                       ref["first_grad"]),
            "first_grad_err": errs[-1],
            "first_grad_err_median": statistics.median(errs),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep),
            "leaves_compared": float(len(keep))}


def reference_steps(conf: dict, init: Dict[str, torch.Tensor],
                    batches: List[torch.Tensor], opt: dict,
                    sample: Dict[str, torch.Tensor],
                    precision: str = "f32",
                    root: Path = registry.HERE) -> dict:
    """AdamW steps over the plain reference of the configuration's
    family (``reference/<family>.py`` under ``root``)."""
    ref = registry.load_reference(conf["family"], root)

    def loss_and_grads(P, toks):
        return ref.loss_and_grads(conf, P, toks, precision)
    return train_steps(loss_and_grads, init, batches, opt, sample)


def check_train(run, wl: dict, root: Path = registry.HERE
                ) -> Dict[str, float]:
    """Reference steps from the weights drawn again from the seed, on the
    same batches, against what the program's set-up steps read."""
    strict_f32()
    prog = run.readings
    batches = run.check_batches
    run.free()
    _free_device()
    ref = reference_steps(run.conf, run.weights.redraw(), batches, run.opt,
                          prog["sample"], root=root)
    _free_device()
    return train_numbers(prog, ref)


def control_train(conf: dict, weights, batches, opt: dict,
                  sample: Dict[str, torch.Tensor],
                  root: Path = registry.HERE) -> Dict[str, Dict[str, float]]:
    """The control (the reference with its products in fp8 in the
    program's place) and the half-batch fault (the reference on half the
    rows), each judged against the f32 reference."""
    strict_f32()
    ref = reference_steps(conf, weights.redraw(), batches, opt, sample,
                          root=root)
    ctl = reference_steps(conf, weights.redraw(), batches, opt, sample,
                          "fp8", root)
    half = reference_steps(conf, weights.redraw(),
                           [b[: b.shape[0] // 2] for b in batches], opt,
                           sample, root=root)
    return {"control": train_numbers(ctl, ref),
            "fault_half_batch": train_numbers(half, ref)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in numbers and numbers[k] <= lim
               for k, lim in limits.items())
