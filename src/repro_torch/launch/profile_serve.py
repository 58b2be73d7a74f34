"""Where the device time of one served query goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

(``--device cpu`` rehearses the script with the reduced models on the CPU,
where no kernel runs on a device.)

Builds the live pipeline at the published widths (bf16, CUDA), serves one
isolated W2 query once unprofiled (warm-up: allocator, cuBLAS handles,
kernel build) and once under ``torch.profiler``, with straggler re-dispatch
off so that every stage runs once, and prints as JSON: the wall time of
the profiled run, the device's busy share of it (the union of kernel
intervals over the wall time), the kernel time by category (the port's
CUDA kernels, GEMMs, everything else) and the 12 heaviest kernels.  The
profiler's own host overhead lengthens the wall time, so the busy share
is a lower bound.
"""
from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.api import HeroSession, SessionOptions
from repro_torch.core.events import EV_STRAGGLER
from repro_torch.kernels import ops
from repro_torch.launch.serve import (NO_STRAGGLER_REDISPATCH,
                                      RecordingLiveBackend, StageCounts,
                                      build_stage_fns)
from repro_torch.rag import default_means, sample_traces

# the port's own kernels, by their __global__ names
PORT_KERNELS = tuple(s for k in ops.KERNELS for s in k.symbols)
GEMM = ("gemm", "xmma", "cutlass", "cublas", "gemv", "nvjet")   # cuBLAS
TOP = 12


def category(name: str) -> str:
    low = name.lower()
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if any(k in low for k in GEMM):
        return "gemm"
    return "other"


def _union_ms(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3          # profiler times are in microseconds


def serve_once(stage_fns) -> dict:
    """One isolated W2 query; -> its wall time and per-stage latencies."""
    traces = sample_traces("finqabench", 1, seed=1)
    backend = RecordingLiveBackend(stage_fns)
    sess = HeroSession(world="sd8gen4", family="qwen3", backend=backend,
                       means=default_means(traces),
                       options=SessionOptions(
                           cfg_overrides=NO_STRAGGLER_REDISPATCH))
    sess.submit(traces[0], wf=2)
    t0 = time.monotonic()
    (result,) = sess.run(mode="isolated", timeout=600)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"wall_s": time.monotonic() - t0,
            "stage_latency_s": result.stage_latency,
            "stragglers": sum(1 for e in backend.events
                              if e[1] == EV_STRAGGLER)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    counts = StageCounts()
    stage_fns = build_stage_fns(device=dev, reduced=dev.type == "cpu",
                                counts=counts)
    warm = serve_once(stage_fns)
    counts.tokens = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve_once(stage_fns)
    assert counts.errors == 0, f"{counts.errors} stage fns raised"
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.end > e.time_range.start]
    by_cat: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0])
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_cat[category(e.name)] += ms
        by_name[e.name][0] += ms
        by_name[e.name][1] += 1
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    out = {
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
        "warm_wall_s": warm["wall_s"], "profiled_wall_s": run["wall_s"],
        "stragglers": run["stragglers"],
        "stage_latency_s": run["stage_latency_s"],
        "tokens": counts.tokens, "kernel_launches": len(kernels),
        "device_busy_ms": busy,
        "device_busy_share": busy / (run["wall_s"] * 1e3),
        "kernel_ms_by_category": dict(by_cat),
        "top_kernels": [{"name": n[:90], "ms": v[0], "launches": v[1]}
                        for n, v in top],
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
