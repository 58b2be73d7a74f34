"""Execution backends behind :class:`repro_torch.api.session.HeroSession`.

One :class:`Backend` protocol, two substrates:

- :class:`SimBackend` — the event-driven SoC simulator
  (``repro_torch.core.simulator``), executing against the ground-truth hardware
  model with bandwidth contention and optional fault injection;
- :class:`LiveBackend` — the wall-clock runtime
  (``repro_torch.serving.executor``), driving real ``PUExecutor`` worker
  threads through the same scheduler.

The same session script runs against either via ``backend="sim"|"live"``.
Both backends forward per-node lifecycle events to an observer callback,
which is how the session implements per-query streaming callbacks
(``on_token`` / ``on_stage_done``).

Admission timers: a node with ``kind == "io"`` and ``payload["arrival"]``
completes no earlier than that absolute (run-relative) time — the
simulator charges it ``max(arrival - now, 0)`` seconds of work, the live
backend sleeps the remaining wall-clock delay.  Gating a query's root
stages on such a node is how continuous multi-query admission works on
both substrates.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from repro_torch.core import checks
from repro_torch.core.dag import DynamicDAG, Node
from repro_torch.core.events import (EV_PREEMPT, EV_REDISPATCH, EV_RETRY,
                               EV_START, EV_STRAGGLER)
from repro_torch.core.perf_model import GroundTruthPerf
from repro_torch.core.scheduler import HeroScheduler
from repro_torch.core.simulator import Simulator

Observer = Callable[[float, str, Node], None]

# BackendRun counters that deliberately have NO per-query QueryResult
# attribution field (repro_torch.analysis.lint rule CNT001 enforces that every
# other counter is paired).  These measure *global* cache pressure or
# round-shared phenomena: an eviction / soft overflow is caused by the
# whole working set, not any one query, and spec_rounds counts shared
# cross-query decode rounds — slicing them per query would assert an
# attribution the physics does not have.
RUN_ONLY_COUNTERS = frozenset({
    "kv_evictions", "kv_evicted_bytes", "kv_soft_overflows", "spec_rounds",
})


@dataclass
class BackendRun:
    """Substrate-independent record of one execution."""

    makespan: float
    events: List[Tuple[float, str, str]]      # (t, event, node id)
    pu_busy: Dict[str, float] = field(default_factory=dict)
    dispatches: int = 0
    redispatches: int = 0
    # chosen-shape histograms from the scheduler's batching policy
    # (decode_width / decode_group / fused_batch) — stamped identically
    # by both substrates so policy telemetry is backend-independent
    batching: Dict[str, Dict[int, int]] = field(default_factory=dict)
    # KV-residency totals (scheduler's tracker; zero when the subsystem
    # is off): decode-round cache moves and the bytes they shipped
    kv_migrations: int = 0
    kv_bytes_moved: float = 0.0
    # spill-tier gathers on the paged store (pages fetched back from
    # dram/disk at dispatch; zero unless ``kv_pages`` is on) — distinct
    # from migrations, which move between PU arenas
    kv_fetches: int = 0
    kv_fetched_bytes: float = 0.0
    # paged-KV totals (zero unless ``kv_pages`` is on): prefix-cache hits,
    # the prefill tokens they skipped, and tier-eviction traffic
    kv_page_hits: int = 0
    kv_hit_tokens: int = 0
    kv_evictions: int = 0
    kv_evicted_bytes: float = 0.0
    # prefix hits declined by the hit-or-recompute rule (fetching the
    # demoted page would cost more than re-prefilling it) and all-pinned
    # capacity breaches (kv_soft_overflow events)
    kv_hit_declined: int = 0
    kv_soft_overflows: int = 0
    # predictive-prefetch totals (zero unless ``kv_prefetch`` is on):
    # staging groups issued, bytes staged, and staged pages the next
    # dispatch found already resident
    kv_prefetches: int = 0
    kv_prefetch_bytes: float = 0.0
    kv_prefetch_hits: int = 0
    # members released from preempted fused dispatches (boundary splits;
    # zero unless ``preempt`` is on).  Counted from "preempt" timeline
    # events on both substrates, so per-query payload-attributed counts
    # sum to this total
    preemptions: int = 0
    # speculative-decoding totals (scheduler's SpecTracker; zero unless
    # ``spec_decode`` is on): draft candidates proposed, candidates the
    # target accepted, and the decode rounds that ran speculatively.
    # Read identically from both substrates, and per-query
    # payload-attributed counts sum to these totals
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    spec_rounds: int = 0


class Backend(Protocol):
    name: str

    def execute(self, dag: DynamicDAG, scheduler: HeroScheduler,
                observer: Optional[Observer] = None,
                timeout: float = 3600.0) -> BackendRun:
        """Run ``dag`` to completion under ``scheduler``."""
        ...


class SimBackend:
    """Wraps :class:`repro_torch.core.simulator.Simulator`.  Time is simulated
    seconds on the modelled SoC; fault-injection knobs mirror the
    simulator's."""

    name = "sim"

    def __init__(self, gt: GroundTruthPerf, straggler_prob: float = 0.0,
                 straggler_slow: float = 4.0, fail_prob: float = 0.0,
                 seed: int = 0):
        self.gt = gt
        self.straggler_prob = straggler_prob
        self.straggler_slow = straggler_slow
        self.fail_prob = fail_prob
        self.seed = seed

    def execute(self, dag: DynamicDAG, scheduler: HeroScheduler,
                observer: Optional[Observer] = None,
                timeout: float = 3600.0) -> BackendRun:
        sim = Simulator(self.gt, scheduler,
                        straggler_prob=self.straggler_prob,
                        straggler_slow=self.straggler_slow,
                        fail_prob=self.fail_prob, seed=self.seed,
                        observer=observer)
        res = sim.run(dag, max_time=timeout)
        spec = getattr(scheduler, "spec", None)
        # count timeline events (fused dispatches fan out to member
        # events), the same convention LiveBackend uses — run-level
        # counters must be backend-independent
        if checks.enabled() and scheduler.kv is not None:
            scheduler.kv.check_quiescent()
        return BackendRun(makespan=res.makespan, events=res.timeline,
                          pu_busy=dict(res.pu_busy),
                          dispatches=sum(1 for e in res.timeline
                                         if e[1] == EV_START),
                          redispatches=sum(1 for e in res.timeline
                                           if e[1] == EV_REDISPATCH),
                          batching={k: dict(v) for k, v in
                                    scheduler.policy_log.items()},
                          kv_migrations=(scheduler.kv.migrations
                                         if scheduler.kv else 0),
                          kv_bytes_moved=(scheduler.kv.bytes_moved
                                          if scheduler.kv else 0.0),
                          kv_fetches=getattr(scheduler.kv, "fetches", 0),
                          kv_fetched_bytes=getattr(scheduler.kv,
                                                   "fetched_bytes", 0.0),
                          kv_page_hits=getattr(scheduler.kv, "hits", 0),
                          kv_hit_tokens=getattr(scheduler.kv,
                                                "hit_tokens", 0),
                          kv_evictions=getattr(scheduler.kv,
                                               "evictions", 0),
                          kv_evicted_bytes=getattr(scheduler.kv,
                                                   "evicted_bytes", 0.0),
                          kv_hit_declined=getattr(scheduler.kv,
                                                  "hit_declined", 0),
                          kv_soft_overflows=getattr(scheduler.kv,
                                                    "soft_overflows", 0),
                          kv_prefetches=getattr(scheduler.kv,
                                                "prefetches", 0),
                          kv_prefetch_bytes=getattr(scheduler.kv,
                                                    "prefetch_bytes", 0.0),
                          kv_prefetch_hits=getattr(scheduler.kv,
                                                   "prefetch_hits", 0),
                          preemptions=sum(1 for e in res.timeline
                                          if e[1] == EV_PREEMPT),
                          drafted_tokens=getattr(spec, "drafted_tokens", 0),
                          accepted_tokens=getattr(spec,
                                                  "accepted_tokens", 0),
                          spec_rounds=getattr(spec, "rounds", 0))


def _instant_fn(node: Node, batch: int):
    return None


class LiveBackend:
    """Wraps :class:`repro_torch.serving.executor.HeroRuntime` over one
    ``PUExecutor`` worker thread per PU.

    ``stage_fns`` maps perf-stage name -> ``(node, batch) -> result``; any
    missing stage runs as an instant no-op, so a bare ``LiveBackend()``
    exercises the real dispatch/heartbeat/retry machinery without models
    ("dry" live mode).  The ``__io__`` entry handles external calls; it is
    wrapped so admission-timer nodes sleep out their remaining arrival
    delay instead.

    With ``coalesce`` on, a stage fn may receive a *fused* node (a
    cross-query coalesced dispatch): ``node.payload["members"]`` lists the
    member nodes, so a coalesce-aware fn can run one batched model call
    and slice results per query; fns that ignore it still work — the
    runtime fans completion out to every member either way.
    """

    name = "live"

    def __init__(self, stage_fns: Optional[Dict[str, Callable]] = None,
                 max_retries: int = 2, poll: float = 0.002):
        self.stage_fns = dict(stage_fns or {})
        self.max_retries = max_retries
        self.poll = poll

    def execute(self, dag: DynamicDAG, scheduler: HeroScheduler,
                observer: Optional[Observer] = None,
                timeout: float = 300.0) -> BackendRun:
        from repro_torch.serving.executor import HeroRuntime, PUExecutor

        inner_io = self.stage_fns.get("__io__", _instant_fn)
        fns = dict(self.stage_fns)
        executors = {p: PUExecutor(p) for p in scheduler.pus if p != "io"}
        rt = HeroRuntime(scheduler, executors, fns,
                         max_retries=self.max_retries, observer=observer)

        def io_fn(node: Node, batch: int):
            arrival = node.payload.get("arrival")
            if arrival is not None:
                # sleep against the runtime's own epoch so "not before
                # arrival" holds in run-relative time (timer threads only
                # start once run() has set _t0)
                base = getattr(rt, "_t0", time.monotonic())
                time.sleep(max(arrival - (time.monotonic() - base), 0.0))
                return None
            return inner_io(node, batch)

        fns["__io__"] = io_fn
        try:
            rt.run(dag, poll=self.poll, timeout=timeout)
        finally:
            for ex in executors.values():
                ex.shutdown()
        if checks.enabled() and scheduler.kv is not None:
            scheduler.kv.check_quiescent()
        events = list(rt.events)
        spec = getattr(scheduler, "spec", None)
        pu_busy: Dict[str, float] = {}
        for n in dag.nodes.values():
            if "coalesced" in n.payload:
                continue    # members share their fused node's interval —
                            # counting both would double-charge the PU
            if n.config is not None and n.start >= 0 and n.finish >= 0:
                pu_busy[n.config[0]] = (pu_busy.get(n.config[0], 0.0)
                                        + n.finish - n.start)
        return BackendRun(
            makespan=dag.makespan(), events=events, pu_busy=pu_busy,
            dispatches=sum(1 for e in events if e[1] == EV_START),
            redispatches=sum(1 for e in events
                             if e[1] in (EV_STRAGGLER, EV_RETRY)),
            batching={k: dict(v) for k, v in
                      scheduler.policy_log.items()},
            kv_migrations=scheduler.kv.migrations if scheduler.kv else 0,
            kv_bytes_moved=(scheduler.kv.bytes_moved
                            if scheduler.kv else 0.0),
            kv_fetches=getattr(scheduler.kv, "fetches", 0),
            kv_fetched_bytes=getattr(scheduler.kv, "fetched_bytes", 0.0),
            kv_page_hits=getattr(scheduler.kv, "hits", 0),
            kv_hit_tokens=getattr(scheduler.kv, "hit_tokens", 0),
            kv_evictions=getattr(scheduler.kv, "evictions", 0),
            kv_evicted_bytes=getattr(scheduler.kv, "evicted_bytes", 0.0),
            kv_hit_declined=getattr(scheduler.kv, "hit_declined", 0),
            kv_soft_overflows=getattr(scheduler.kv, "soft_overflows", 0),
            kv_prefetches=getattr(scheduler.kv, "prefetches", 0),
            kv_prefetch_bytes=getattr(scheduler.kv, "prefetch_bytes", 0.0),
            kv_prefetch_hits=getattr(scheduler.kv, "prefetch_hits", 0),
            preemptions=sum(1 for e in events if e[1] == EV_PREEMPT),
            drafted_tokens=getattr(spec, "drafted_tokens", 0),
            accepted_tokens=getattr(spec, "accepted_tokens", 0),
            spec_rounds=getattr(spec, "rounds", 0))
