"""What a run records: host spans, the shapes of each K2 call (through
shims on ``repro_torch.kernels.ops`` and the backward kernel's entry,
installed only in a traced run), and the device trace of
``torch.profiler`` over the traced window."""
from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from hero_bench import costs, kernel_names, stats


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


def _itemsize_and_type(t) -> Tuple[int, str]:
    import torch
    return t.element_size(), ("float32" if t.dtype == torch.float32
                              else "bfloat16")


@contextlib.contextmanager
def kernel_shims(rec: Recorder):
    """Record the shape-derived cost of every K2 and K2-backward call
    while ``rec.shapes_on``; the calls themselves are unchanged."""
    from repro_torch.kernels import flash_attention_bwd as fbwd
    from repro_torch.kernels import ops

    orig = (ops.flash_attention, fbwd.flash_attention_bwd)

    def flash(q, k, v, *, causal=True, q_offset=0, kv_len=None,
              kv_positions=None, window=0, scale=None):
        if rec.shapes_on:
            b, sq, h, e = q.shape
            n, ev = k.shape[2], v.shape[-1]
            size, dt = _itemsize_and_type(q)
            lse = q.requires_grad or k.requires_grad
            rec.kernel_call("K2", costs.k2_forward(
                b, sq, h, n, e, ev, k.shape[1] if kv_len is None else kv_len,
                causal, q_offset, size, dt, lse=lse))
        return orig[0](q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=kv_len, kv_positions=kv_positions,
                       window=window, scale=scale)

    def flash_bwd(q, k, v, *args, **kwargs):
        if rec.shapes_on:
            b, sq, h, e = q.shape
            size, dt = _itemsize_and_type(q)
            causal = kwargs.get("causal", True)
            q_offset = kwargs.get("q_offset", 0)
            kv_len = kwargs.get("kv_len") or k.shape[1]
            rec.kernel_call("K2-bwd", costs.k2_backward(
                b, sq, h, k.shape[2], e, v.shape[-1], kv_len, causal,
                q_offset, size, dt))
        return orig[1](q, k, v, *args, **kwargs)

    ops.flash_attention, fbwd.flash_attention_bwd = flash, flash_bwd
    try:
        yield
    finally:
        ops.flash_attention, fbwd.flash_attention_bwd = orig


@dataclass
class DeviceTrace:
    """Kernel intervals of the traced window, in host monotonic seconds."""
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

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

    def top_ops(self, n: int = 10) -> List[List]:
        out: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.kernels:
            out[name[:120]] += e - s
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:n]]


class Profiler:
    """``torch.profiler`` over the traced window; kernel times are mapped
    to host monotonic seconds through a marker range recorded at the
    window's start."""

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
        with record_function("hero_bench.window_open"):
            pass

    def stop(self) -> DeviceTrace:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.monotonic()
        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        marker = None
        kernels = []
        for e in events:
            if e.name == "hero_bench.window_open" and marker is None:
                marker = e.time_range.start
            elif (e.device_type == torch.autograd.DeviceType.CUDA
                  and e.time_range.end > e.time_range.start):
                kernels.append((e.name, e.time_range.start,
                                e.time_range.end))
        if marker is None:
            raise RuntimeError("profiler lost the window marker")
        off = self._t0 - marker / 1e6
        ks = [(n, s / 1e6 + off, e / 1e6 + off) for n, s, e in kernels]
        return DeviceTrace(ks, (self._t0, t1))


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
