"""The split of a train step by the program's own spans, over the traced
window of a train cell.

The port records its train step as profiler ranges
(``repro_torch/core/spans.py``): ``train.step`` around
``train.forward``, ``train.backward`` and ``train.optimizer``, and
``lm.block`` for each block, again inside the backward where remat
recomputes it.  ``tracing.Profiler`` keeps them in the trace beside the
kernels, with the runtime's launches.  A kernel belongs to a span when
the host start of the launch that issued it falls inside that span.
Kernel and launch are matched by the profiler's correlation id,
whichever thread launched it: autograd's device thread launches the
backward while the main thread waits in ``train.backward``.  Per-step
numbers are over the ``train.step`` spans that open and close inside the
traced window; the profiler synchronizes before it stops, so every
kernel those steps launched is in the trace.  The metric readers
(``readers.span_ms_per_step`` and its neighbours) read a span by name
with the functions here.

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
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from hero_bench import kernel_names, tracing  # noqa: E402
from hero_bench.tracing import DeviceTrace  # noqa: E402

# the program's span names (repro_torch/core/spans.py)
STEP = "repro_torch.train.step"
FORWARD = "repro_torch.train.forward"
BACKWARD = "repro_torch.train.backward"
OPTIMIZER = "repro_torch.train.optimizer"
BLOCK = "repro_torch.lm.block"

# the runtime's host events that launch a kernel (``cudaMemcpyAsync`` and
# ``cudaStreamSynchronize`` launch none)
LAUNCH = ("cudaLaunch", "cuLaunch")


def complete_steps(trace: DeviceTrace) -> List[Tuple[float, float]]:
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


def spans_in_steps(trace: DeviceTrace, name: str,
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


def launched_in(trace: DeviceTrace, spans: Iterable[Tuple[float, float]]
                ) -> List[Tuple[str, float, float]]:
    """The kernels whose launch began inside ``spans``."""
    where = _Intervals(spans)
    ids = {c for _, c, s, _ in trace.runtime if where.covers(s)}
    return [k for k, c in zip(trace.kernels, trace.kernel_ids) if c in ids]


def _device_s(kernels: Iterable[Tuple[str, float, float]]) -> float:
    return sum(e - s for _, s, e in kernels)


def span_device_ms(trace: DeviceTrace, name: str,
                   within: Optional[str] = None) -> Optional[float]:
    """Device ms a complete step of the kernels launched inside the
    ``name`` spans of the complete steps (with ``within``, only those
    inside a ``within`` span); None without a complete step or such a
    span."""
    n = len(complete_steps(trace))
    spans = spans_in_steps(trace, name, within)
    if not n or not spans:
        return None
    return 1e3 * _device_s(launched_in(trace, spans)) / n


def span_host_ms(trace: DeviceTrace, name: str) -> Optional[float]:
    """Host ms a complete step inside the ``name`` spans; None without a
    complete step or such a span."""
    n = len(complete_steps(trace))
    spans = spans_in_steps(trace, name)
    if not n or not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / n


def launches(trace: DeviceTrace) -> Optional[float]:
    """Kernel launches a complete step; None without one."""
    steps = complete_steps(trace)
    if not steps:
        return None
    in_steps = _Intervals(steps)
    return sum(1 for name, _, s, _ in trace.runtime
               if name.startswith(LAUNCH) and in_steps.covers(s)
               ) / len(steps)


def split(trace: DeviceTrace,
          host_spans: Iterable[tracing.Span] = ()) -> Dict[str, object]:
    """The step's split, per complete step, under the names of the
    benchmark's metrics; {} without a complete step."""
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
        out[f"{short}_ms.train"] = span_device_ms(trace, span)
        out[f"{short}_host_ms.train"] = span_host_ms(trace, span)
        kernels = launched_in(trace, spans_in_steps(trace, span))
        phase_s += _device_s(kernels)
        by_label[short] = collections.defaultdict(float)
        for name, s, e in kernels:
            by_label[short][kernel_names.label(name)] += 1e3 * (e - s) / n
    out["recompute_ms.train"] = span_device_ms(trace, BLOCK, within=BACKWARD)
    out["launches.train"] = launches(trace)
    step_s = _device_s(launched_in(trace, steps))
    out["phase_share"] = phase_s / step_s if step_s > 0 else None
    out["step_device_ms"] = 1e3 * step_s / n
    out["phase_ms_by_kernel"] = {k: dict(v) for k, v in by_label.items()}
    out["idle_gaps"] = tracing.idle_gaps(
        trace, [*host_spans, *trace.program_spans()], 12)
    return out


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
