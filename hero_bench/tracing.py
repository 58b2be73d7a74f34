"""What a run records: host spans, the cost of each call of a kernel the
benchmark prices (through shims on the attributes that ``kernels/<label>.py``
names, installed only in a traced run), and the device trace of
``torch.profiler`` over the traced window, with the program's own spans
and the launches that issued each kernel."""
from __future__ import annotations

import collections
import contextlib
import importlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

from hero_bench import costs, kernel_names, registry, stats

# the program's spans are profiler ranges whose names start with PREFIX
# (repro_torch/core/spans.py); the CUDA runtime's and driver's host events
# (cudaLaunchKernel, cuLaunchKernelEx for cuBLAS's nvjet,
# cudaMemcpyAsync, ...) start with RUNTIME
PREFIX = "repro_torch."
RUNTIME = "cu"
MARKER = "hero_bench.window_open"


@dataclass
class Span:
    name: str
    start: float            # host monotonic seconds
    end: float


class Recorder:
    """Host spans and the traced window's kernel calls, kept in memory."""

    def __init__(self):
        self.spans: List[Span] = []
        self.calls: List[Tuple[float, str, costs.Cost]] = []
        self.shapes_on = False

    @contextlib.contextmanager
    def span(self, name: str):
        """Times the block, while ``shapes_on``."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            if self.shapes_on:
                self.spans.append(Span(name, t0, time.monotonic()))

    def kernel_call(self, label: str, cost: costs.Cost) -> None:
        if self.shapes_on:
            self.calls.append((time.monotonic(), label, cost))


def _shim(rec: Recorder, label: str, fn, cost):
    def shim(*args, **kwargs):
        if rec.shapes_on:
            rec.kernel_call(label, cost(*args, **kwargs))
        return fn(*args, **kwargs)
    return shim


@contextlib.contextmanager
def kernel_shims(rec: Recorder, root: Path = registry.HERE):
    """Record the cost of every call of each kernel file's ``TARGET``
    while ``rec.shapes_on``; the calls themselves are unchanged."""
    installed = []
    try:
        for label, mod in registry.load_kernels(root).items():
            if not hasattr(mod, "TARGET"):
                continue
            owner = importlib.import_module(mod.TARGET[0])
            fn = getattr(owner, mod.TARGET[1])
            setattr(owner, mod.TARGET[1], _shim(rec, label, fn, mod.cost))
            installed.append((owner, mod.TARGET[1], fn))
        yield
    finally:
        for owner, attr, fn in reversed(installed):
            setattr(owner, attr, fn)


@dataclass
class DeviceTrace:
    """The traced window: kernel intervals ``(name, start, end)``, the
    program's spans ``(name, thread, start, end)``, the runtime's host
    events ``(name, correlation id, start, end)`` and each kernel's
    correlation id, in ``kernels``' order; all times in host monotonic
    seconds."""
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)
    spans: List[Tuple[str, int, float, float]] = field(default_factory=list)
    runtime: List[Tuple[str, int, float, float]] = field(
        default_factory=list)
    kernel_ids: List[int] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return stats.union_length((s, e) for _, s, e in self.kernels)

    def by_label(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.kernels:
            out[kernel_names.label(name)] += e - s
        return dict(out)

    def program_spans(self) -> List[Span]:
        """The program's spans as ``Span``, named without the package
        prefix (``train.forward``, ``lm.block``)."""
        return [Span(n[len(PREFIX):], s, e) for n, _, s, e in self.spans]

    def top_ops(self, n: int = 10) -> List[List]:
        out: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.kernels:
            out[name[:120]] += e - s
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:n]]


class Profiler:
    """``torch.profiler`` over the traced window; kernel times, the
    program's spans and the runtime's launches are mapped to host
    monotonic seconds through a marker range recorded at the window's
    start."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.monotonic()
        with record_function(MARKER):
            pass

    def stop(self) -> DeviceTrace:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.monotonic()
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        marker = None
        kernels, ids, spans, runtime = [], [], [], []
        for e in self._prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.name == MARKER and marker is None:
                marker = s
            elif e.device_type == cuda:
                if t > s:
                    kernels.append((e.name, s, t))
                    ids.append(e.id)
            elif e.name.startswith(PREFIX):
                spans.append((e.name, e.thread, s, t))
            elif e.name.startswith(RUNTIME):
                runtime.append((e.name, e.id, s, t))
        if marker is None:
            raise RuntimeError("profiler lost the window marker")
        off = self._t0 - marker / 1e6

        def host(ev):
            return (*ev[:-2], ev[-2] / 1e6 + off, ev[-1] / 1e6 + off)
        return DeviceTrace([host(k) for k in kernels], (self._t0, t1),
                           [host(sp) for sp in spans],
                           [host(r) for r in runtime], ids)


def idle_gaps(trace: DeviceTrace, spans: List[Span], n: int = 10
              ) -> List[List]:
    """The device's idle stretches in the traced window, summed by the
    innermost host span running at their middle ("no host span" where
    none is), the longest first."""
    out: Dict[str, float] = collections.defaultdict(float)
    lo, hi = trace.window
    for a, b in stats.gaps(((s, e) for _, s, e in trace.kernels), lo, hi):
        mid = (a + b) / 2
        inner = [sp for sp in spans if sp.start <= mid < sp.end]
        name = (min(inner, key=lambda sp: sp.end - sp.start).name
                if inner else "no host span")
        out[name] += b - a
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]
