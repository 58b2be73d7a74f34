"""The train cells: the port's train step (``training.make_train_step``:
loss, gradients with remat as the configuration states, AdamW) on the
benchmark's weights and batches.  Set-up builds one step function with
its parameters and optimizer state, drives it through its first three
steps on the feed's first batches (what the reference follows), and
hands the same objects to the window, which runs one step after another
on further batches."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from hero_bench import models, registry, traffic
from hero_bench.tracing import Profiler, Recorder, kernel_shims

CHECK_STEPS = 3


@dataclass
class TrainRun:
    conf: dict
    opt: dict
    weights: models.Weights
    readings: dict
    check_batches: List[torch.Tensor]
    step_ends: List[float]        # device seconds after the window opened
    seconds: float
    tokens_per_step: int
    setup_s: float
    memory_peak: int              # the whole run's
    window_peak: int              # the measured window's, after a reset
    rec: Recorder
    trace: object = None
    trace_step_ends: Optional[List[float]] = None
    state: Optional[list] = None

    def free(self) -> None:
        self.state = None


def optimizer_args(conf: dict) -> dict:
    """AdamW's settings as the configuration file states them."""
    return dict(conf["run"]["optimizer"])


def run(wl: dict, conf: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t_proc0: float,
        root: Path = registry.HERE) -> TrainRun:
    """The model is built by the family the configuration names
    (``families/<family>.py`` under ``root``)."""
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from hero_bench.check import sample_indices
    mix = wl["mix"]
    family = registry.load_family(conf["family"], root)
    cfg = family.model_config(conf)
    opt = optimizer_args(conf)
    tcfg = TrainConfig(optimizer=AdamWConfig(**opt))
    _, step = make_train_step(cfg, tcfg, device)
    params, weights = models.program_model(
        cfg, seed, device, lambda leaf, shape: family.init_scale(
            leaf, shape, conf), trainable=True)
    state = adamw_init(params, tcfg.optimizer)
    feed = traffic.train_batches(mix, seed, conf["vocab_size"], device)
    rec = Recorder()
    sample = sample_indices({k: p.numel() for k, p in
                             params.named_parameters()}, seed)
    losses, batches = [], []
    first: Dict[str, float] = {}
    for i in range(CHECK_STEPS):
        batch = next(feed)
        batches.append(batch["tokens"])
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"])
        if i == 0:
            # AdamW's first moment after one step is (1 - b1) times the
            # clipped gradient it got: its norm, and the sampled entries
            # on the host, for the reference
            first = {k: float(m.norm()) / (1 - opt["b1"])
                     for k, m in state.m.items()}
            first_s = {k: (m.reshape(-1)[sample[k].to(m.device)]
                           / (1 - opt["b1"])).cpu()
                       for k, m in state.m.items()}
    init = weights.redraw()
    change = {k: float((p.detach().float() - init[k].float()).norm())
              for k, p in params.named_parameters()}
    del init
    readings = {"losses": [float(x) for x in losses], "first_grad": first,
                "change": change, "first_sample": first_s,
                "sample": sample}
    tokens = mix["batch"] * mix["seq"]
    holder = [params, state]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    run_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        # the window's own peak: set-up's copies are not the step's
        torch.cuda.reset_peak_memory_stats(device)
    with kernel_shims(rec, root) if trace else contextlib.nullcontext():
        t_open = time.monotonic()
        setup_s = t_open - t_proc0
        ends, trace_ends, dev_trace = _window(step, holder, feed, seconds,
                                              trace, mix, rec, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    return TrainRun(conf, opt, weights, readings, batches, ends, seconds,
                    tokens, setup_s, max(run_peak, window_peak),
                    window_peak, rec, dev_trace, trace_ends, holder)


def _window(step, holder, feed, seconds, trace, mix, rec, device
            ) -> Tuple[List[float], Optional[List[float]], object]:
    """Steps until the host clock passes the window's end, at most two in
    flight; -> each step's end in device seconds after the open."""
    cuda = device.type == "cuda"
    t_open = time.monotonic()
    prof = None
    if trace:
        prof = Profiler() if cuda else None
        rec.shapes_on = True
        if prof:
            prof.start()
    t_trace = t_open + traffic.trace_span(mix, seconds)
    dev_trace, trace_ends = None, None
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    evs: list = []
    host_ends: List[float] = []
    while time.monotonic() < t_open + seconds:
        with rec.span("train_step"):
            holder[0], holder[1], _ = step(holder[0], holder[1], next(feed))
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append(ev)
            if len(evs) >= 2:
                with rec.span("wait_for_step"):
                    evs[-2].synchronize()
        else:
            host_ends.append(time.monotonic() - t_open)
        if trace and time.monotonic() >= t_trace and rec.shapes_on:
            rec.shapes_on = False
            if prof:
                dev_trace = prof.stop()
                trace_ends = [start.elapsed_time(e) / 1e3 for e in evs]
    if cuda:
        torch.cuda.synchronize(device)
        ends = [start.elapsed_time(e) / 1e3 for e in evs]
    else:
        ends = host_ends
    if trace and rec.shapes_on:
        rec.shapes_on = False
        if prof:
            dev_trace = prof.stop()
            trace_ends = ends
    return ends, trace_ends, dev_trace


def completed_steps(ends: List[float], until: float) -> float:
    """Steps completed by ``until`` (device seconds after the open), the
    step in progress counted by the share of it done."""
    done, prev = 0.0, 0.0
    for e in ends:
        if e <= until:
            done += 1
            prev = e
        else:
            done += max(0.0, (until - prev) / (e - prev))
            break
    return done
