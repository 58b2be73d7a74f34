"""One measured run of a cell: set-up, the window, the comparison, and
the result line with every metric the cell reports (``BENCHMARK.json``)
read by its own reader under ``metrics/``."""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from hero_bench import check, registry, tracing


@dataclass
class RunView:
    """What the metric readers read."""
    seconds: float
    setup_s: float
    rec: Optional[tracing.Recorder] = None
    trace: Optional[tracing.DeviceTrace] = None
    step_ends: List[float] = field(default_factory=list)
    trace_step_ends: Optional[List[float]] = None
    tokens_per_step: int = 0
    step_flops: float = 0.0
    memory_peak: int = 0
    window_peak: int = 0


def _train(wl, conf, seed, seconds, trace, device, t0, root):
    from hero_bench import train
    run = train.run(wl, conf, seed, seconds, trace, device, t0, root)
    mix = wl["mix"]
    family = registry.load_family(conf["family"], root)
    view = RunView(seconds, run.setup_s, rec=run.rec,
                   trace=run.trace, step_ends=run.step_ends,
                   trace_step_ends=run.trace_step_ends,
                   tokens_per_step=run.tokens_per_step,
                   step_flops=family.train_step_flops(
                       conf, mix["batch"], mix["seq"]),
                   memory_peak=run.memory_peak,
                   window_peak=run.window_peak)
    numbers = check.check_train(run, wl, root)
    return view, numbers, len(run.step_ends), 0


def read_metrics(cell: str, view: RunView, trace: bool,
                 bench: Optional[dict] = None,
                 root: Path = registry.HERE) -> Dict[str, dict]:
    kind = "per_layer" if trace else "end_to_end"
    out = {}
    for name, entry in registry.metrics_of(cell, kind, bench).items():
        value = registry.load_metric(name, root).read(view)
        if value is not None:
            out[name] = {"value": float(value), "unit": entry["unit"]}
    return out


def measure(wl: dict, seed: int, seconds: float, trace: bool,
            device: torch.device, t0: float, bench: Optional[dict] = None,
            conf: Optional[dict] = None, root: Path = registry.HERE):
    """-> (result line as a dict, the numbers compared with limits).
    The configuration, its family and reference, the kernel files that
    the shims read and the metric readers are found by name under
    ``root``."""
    conf = conf if conf is not None else registry.load_config(wl["config"],
                                                              root)
    if wl["mix"]["kind"] != "train":
        raise ValueError(f"no driver for a {wl['mix']['kind']!r} mix")
    view, numbers, attempted, failed = _train(wl, conf, seed, seconds,
                                              trace, device, t0, root)
    metrics = read_metrics(wl["name"], view, trace, bench, root)
    for name, value in summary(view).items():
        print(f"{name}: {value!r}", file=sys.stderr)
    limits = wl["limits"]
    for name, value in numbers.items():
        if name not in limits:
            print(f"reading {name}: {value!r}", file=sys.stderr)
    correct = check.verdict(numbers, limits)
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in limits.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": wl["chips"], "memory_peak_bytes": view.memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and view.trace is not None:
        dev["busy_s"] = view.trace.busy_s()
        dev["window_s"] = view.trace.window_s
        result["breakdown"] = {
            "device_ops": view.trace.top_ops(10),
            "idle_gaps": tracing.idle_gaps(
                view.trace, [*view.rec.spans, *view.trace.program_spans()],
                10)}
    result["checks"] = checks
    return result, checks


def summary(view: RunView) -> Dict[str, object]:
    """Lines printed before the result: counts a reader of the log wants
    beside the metrics."""
    return {"setup_s": view.setup_s, "steps_in_window": len(view.step_ends),
            "window_peak_bytes": view.window_peak}
