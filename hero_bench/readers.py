"""Arithmetic the metric readers under ``metrics/`` share.  Each returns
None where its run has nothing to read."""
from __future__ import annotations

from typing import Iterable, Optional

from hero_bench import peaks, phases
from hero_bench.train import completed_steps


def idle_share(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def kernel_roofline(run, labels: Iterable[str]) -> Optional[float]:
    """The least time the recorded calls of these kernels need on the
    chip over the device time of their launches in the trace."""
    labels = set(labels)
    if run.trace is None or run.rec is None:
        return None
    dev = sum(v for k, v in run.trace.by_label().items() if k in labels)
    bound = sum(c.bound_s() for _, lab, c in run.rec.calls if lab in labels)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev


def trace_steps(run) -> Optional[float]:
    if run.trace is None or not run.trace_step_ends:
        return None
    return completed_steps(run.trace_step_ends, run.trace.window_s)


def train_mfu(run) -> Optional[float]:
    n = trace_steps(run)
    if not n:
        return None
    return 100.0 * n * run.step_flops / (run.trace.window_s
                                         * peaks.BF16_FLOPS)


def other_kernels_ms_per_step(run) -> Optional[float]:
    n = trace_steps(run)
    if not n:
        return None
    return 1e3 * run.trace.by_label().get("other", 0.0) / n


# the program's spans, by the name the program records them under
# (``repro_torch.train.forward``), a complete step of the traced window


def span_ms_per_step(run, name: str, within: Optional[str] = None
                     ) -> Optional[float]:
    """Device ms of the kernels launched inside the ``name`` spans (with
    ``within``, only those inside a ``within`` span)."""
    if run.trace is None:
        return None
    return phases.span_device_ms(run.trace, name, within)


def span_host_ms_per_step(run, name: str) -> Optional[float]:
    """Host ms inside the ``name`` spans."""
    if run.trace is None:
        return None
    return phases.span_host_ms(run.trace, name)


def launches_per_step(run) -> Optional[float]:
    """The runtime's kernel launches."""
    if run.trace is None:
        return None
    return phases.launches(run.trace)
