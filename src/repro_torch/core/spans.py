"""Names of the profiler ranges the training path records, and the one
helper that opens them.

A span is a ``torch.profiler`` range: it exists only in a profiler's
event stream, beside the kernels and their launches, on the profiler's
clock, and nothing else keeps it.  With no profiler active,
:func:`span` returns one shared null context, so a span costs one
attribute read.

The ranges are function-scope record functions
(``torch._C._profiler._RecordFunctionFast``), not the user annotations
of ``torch.profiler.record_function``: the profiler mirrors each user
annotation on the device as an interval from the first kernel launched
inside it to the last, and every reader of a device trace that takes the
device's events for kernels (the union of kernel intervals, the time by
kernel name) would count that interval as a kernel.  A function-scope
range is not a dispatcher operator either, so a selective-checkpoint
policy never sees it, and a recompute records it again because it runs
the checkpointed function again.

Every name starts with :data:`PREFIX`, which tells the ranges apart from
the profiler's ATen operators.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."

# -- a train step (training/train_loop.py, training/optimizer.py) -----------
SPAN_TRAIN_STEP = "repro_torch.train.step"      # the whole train_step
SPAN_FORWARD = "repro_torch.train.forward"      # the loss, a microbatch
SPAN_BACKWARD = "repro_torch.train.backward"    # torch.autograd.grad
SPAN_OPTIMIZER = "repro_torch.train.optimizer"  # adamw_update

# -- a block in train mode (models/lm.py ``_remat``): once in the forward,
#    and again in the backward where remat recomputes it ---------------------
SPAN_BLOCK = "repro_torch.lm.block"

ALL_SPANS = frozenset({SPAN_TRAIN_STEP, SPAN_FORWARD, SPAN_BACKWARD,
                       SPAN_OPTIMIZER, SPAN_BLOCK})

# -- the dropless expert layer (models/moe.py ``moe_ffn_dropless``), inside
#    a block: again in the backward where remat recomputes it; the
#    products' own backward runs outside them -------------------------------
SPAN_MOE_ROUTE = "repro_torch.moe.route"        # router, loss, sort, gather
SPAN_MOE_EXPERTS = "repro_torch.moe.experts"    # grouped products, SiLU·up
SPAN_MOE_COMBINE = "repro_torch.moe.combine"    # gates, scatter back

MOE_SPANS = frozenset({SPAN_MOE_ROUTE, SPAN_MOE_EXPERTS, SPAN_MOE_COMBINE})

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler is active, else
    the shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
