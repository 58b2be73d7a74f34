"""The split of a train step by the program's own spans, over the traced
window of a train cell.

The port records its train step as profiler ranges
(``repro_torch/core/spans.py``): ``train.step`` around
``train.forward``, ``train.backward`` and ``train.optimizer``, and
``lm.block`` for each block, again inside the backward where remat
recomputes it.  A kernel belongs to a phase when the host start of the
launch that issued it falls inside that phase's span.  Kernel and launch
are matched by the profiler's correlation id, whichever thread launched
it: autograd's device thread launches the backward while the main thread
waits in ``train.backward``.  Per-step numbers are over the
``train.step`` spans that open and close inside the traced window; the
profiler synchronizes before it stops, so every kernel those steps
launched is in the trace.

:class:`SpanProfiler` is ``tracing.Profiler`` keeping the spans and the
launches besides the kernels.  The benchmark's own runs do not use it:

    python3 hero_bench/phases.py --workload qwen3-1.7b-train-4x4096 \\
        --seed 1234 --seconds 8

runs the cell's set-up and window as ``run.py --trace 1`` does, with no
comparison after it, and prints one JSON line: each phase's device ms
and host ms a step, the recompute's device ms, the launches a step, the
share of the steps' kernel time that the three phases launched, each
phase's device ms by kernel label (``kernel_names.label``), and the
device's idle time by the innermost span, the program's included.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from hero_bench import kernel_names, tracing  # noqa: E402

# the program's span names (repro_torch/core/spans.py)
PREFIX = "repro_torch."
STEP = "repro_torch.train.step"
FORWARD = "repro_torch.train.forward"
BACKWARD = "repro_torch.train.backward"
OPTIMIZER = "repro_torch.train.optimizer"
BLOCK = "repro_torch.lm.block"

# host events of the CUDA runtime and driver (cudaLaunchKernel,
# cuLaunchKernelEx for cuBLAS's nvjet, cudaMemcpyAsync, ...), of which the
# kernel launches begin with LAUNCH
RUNTIME = "cu"
LAUNCH = ("cudaLaunch", "cuLaunch")


@dataclass
class SpanTrace(tracing.DeviceTrace):
    """A device trace with the program's spans ``(name, thread, start,
    end)``, the runtime's host events ``(name, correlation id, start,
    end)`` and each kernel's correlation id, in ``kernels``' order; all
    times in host monotonic seconds."""
    spans: List[Tuple[str, int, float, float]] = field(default_factory=list)
    runtime: List[Tuple[str, int, float, float]] = field(
        default_factory=list)
    kernel_ids: List[int] = field(default_factory=list)


class SpanProfiler(tracing.Profiler):
    """``tracing.Profiler``, whose trace keeps the program's spans and
    the runtime's host events too, on the kernels' clock."""

    def stop(self) -> SpanTrace:
        import torch
        base = super().stop()
        events = self._prof.events()
        marker = next(e.time_range.start for e in events
                      if e.name == "hero_bench.window_open")
        off = self._t0 - marker / 1e6
        cuda = torch.autograd.DeviceType.CUDA
        spans, runtime, ids = [], [], []
        for e in events:
            s, t = e.time_range.start / 1e6 + off, e.time_range.end / 1e6 + off
            if e.device_type == cuda:
                if e.time_range.end > e.time_range.start:
                    ids.append(e.id)
            elif e.name.startswith(PREFIX):
                spans.append((e.name, e.thread, s, t))
            elif e.name.startswith(RUNTIME):
                runtime.append((e.name, e.id, s, t))
        if len(ids) != len(base.kernels):
            raise RuntimeError("kernels and their correlation ids differ")
        return SpanTrace(base.kernels, base.window, spans, runtime, ids)


def complete_steps(trace: SpanTrace) -> List[Tuple[float, float]]:
    """The ``train.step`` spans that open and close inside the window."""
    lo, hi = trace.window
    return sorted((s, e) for n, _, s, e in trace.spans
                  if n == STEP and lo <= s and e <= hi)


class _Intervals:
    """Host intervals, merged where they overlap; ``covers(t)``: t lies
    in one."""

    def __init__(self, spans: Iterable[Tuple[float, float]]):
        merged: List[List[float]] = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ends[i]


def _inside(inner: Tuple[float, float], outer: _Intervals) -> bool:
    i = bisect.bisect_right(outer.starts, inner[0]) - 1
    return i >= 0 and inner[1] <= outer.ends[i]


def spans_in_steps(trace: SpanTrace, name: str,
                   within: Optional[str] = None) -> List[Tuple[float, float]]:
    """The ``name`` spans inside complete steps (and, with ``within``,
    inside a ``within`` span), on any thread."""
    steps = _Intervals(complete_steps(trace))
    out = [(s, e) for n, _, s, e in trace.spans
           if n == name and _inside((s, e), steps)]
    if within is not None:
        outer = _Intervals((s, e) for n, _, s, e in trace.spans
                           if n == within)
        out = [sp for sp in out if _inside(sp, outer)]
    return out


def launched_in(trace: SpanTrace, spans: Iterable[Tuple[float, float]]
                ) -> List[Tuple[str, float, float]]:
    """The kernels whose launch began inside ``spans``."""
    where = _Intervals(spans)
    ids = {c for _, c, s, _ in trace.runtime if where.covers(s)}
    return [k for k, c in zip(trace.kernels, trace.kernel_ids) if c in ids]


def _device_s(kernels: Iterable[Tuple[str, float, float]]) -> float:
    return sum(e - s for _, s, e in kernels)


def split(trace: SpanTrace,
          host_spans: Iterable[tracing.Span] = ()) -> Dict[str, object]:
    """The step's split, per complete step, under the names the
    benchmark's metrics would have; {} without a complete step."""
    steps = complete_steps(trace)
    n = len(steps)
    if not n:
        return {}
    out: Dict[str, object] = {"steps": n}
    names = {FORWARD: "forward", BACKWARD: "backward",
             OPTIMIZER: "optimizer"}
    phase_s = 0.0
    by_label: Dict[str, Dict[str, float]] = {}
    for span, short in names.items():
        spans = spans_in_steps(trace, span)
        kernels = launched_in(trace, spans)
        dev = _device_s(kernels)
        phase_s += dev
        out[f"{short}_ms.train"] = 1e3 * dev / n
        out[f"{short}_host_ms.train"] = 1e3 * sum(e - s for s, e in spans) / n
        by_label[short] = collections.defaultdict(float)
        for name, s, e in kernels:
            by_label[short][kernel_names.label(name)] += 1e3 * (e - s) / n
    out["recompute_ms.train"] = 1e3 * _device_s(launched_in(
        trace, spans_in_steps(trace, BLOCK, within=BACKWARD))) / n
    in_steps = _Intervals(steps)
    out["launches.train"] = sum(
        1 for name, _, s, _ in trace.runtime
        if name.startswith(LAUNCH) and in_steps.covers(s)) / n
    step_s = _device_s(launched_in(trace, steps))
    out["phase_share"] = phase_s / step_s if step_s > 0 else None
    out["step_device_ms"] = 1e3 * step_s / n
    out["phase_ms_by_kernel"] = {k: dict(v) for k, v in by_label.items()}
    out["idle_gaps"] = tracing.idle_gaps(
        trace, [*host_spans, *program_spans(trace)], 12)
    return out


def program_spans(trace: SpanTrace) -> List[tracing.Span]:
    """The program's spans as ``tracing.Span``, named without the
    package prefix (``train.forward``, ``lm.block``)."""
    return [tracing.Span(n[len(PREFIX):], s, e)
            for n, _, s, e in trace.spans]


def main(argv=None) -> int:
    import torch
    from hero_bench import registry, train
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8)
    args = ap.parse_args(argv)
    wl = registry.load_workload(args.workload)
    if wl["mix"]["kind"] != "train":
        raise SystemExit(f"{args.workload}: not a train cell")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    conf = registry.load_config(wl["config"])
    train.Profiler = SpanProfiler       # the traced window keeps the spans
    run = train.run(wl, conf, args.seed, args.seconds, True,
                    torch.device("cuda"), time.monotonic())
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "busy_s": run.trace.busy_s(), "window_s": run.trace.window_s,
           **split(run.trace, run.rec.spans)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
