"""Event-driven SoC simulator — the execution substrate for validation.

Plays the role of the phones in paper §6: executes a (dynamic) RAG DAG
against the *ground-truth* hardware model, with time-varying bandwidth
contention — node progress rates are rescaled by 1/φ(B(t)) whenever the
active set changes, so the realized latency is p⁰·φ̄ exactly as in Eq. 2.

The scheduler under test only sees the fitted LinearPerfModel; modelling
error is therefore part of the experiment, as on real hardware.

Fault-tolerance hooks: ``straggler_prob``/``fail_prob`` perturb node
execution; the scheduler's speculative re-dispatch (straggler_factor) and
retry close the loop — exercised by tests/test_fault_tolerance.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dag import DONE, READY, DynamicDAG, Node
from repro_torch.core.events import (EV_CANCELLED, EV_DONE, EV_KV_FETCH,
                               EV_KV_MIGRATE, EV_PREEMPT, EV_REDISPATCH,
                               EV_START, EV_TOKENS, SPILL_TIERS)
from repro_torch.core.partitioner import (ceil_passes, dispatch_passes,
                                    fused_boundary_index)
from repro_torch.core.perf_model import Config, GroundTruthPerf
from repro_torch.core.scheduler import Dispatch, HeroScheduler
from repro_torch.core.spec_decode import spec_passes


@dataclass
class ActiveTask:
    node: Node
    pu: str
    batch: int
    work_left: float          # seconds of uncontended work remaining
    bandwidth: float          # ground-truth demand b_v(c)
    rate: float = 1.0         # 1/φ(B(t)) — updated on every event
    dispatched_at: float = 0.0
    predicted: float = 0.0    # scheduler's ETA (straggler detection)
    work_total: float = 0.0   # seconds at dispatch (progress = 1 - left/total)


@dataclass
class SimResult:
    makespan: float
    timeline: List[Tuple[float, str, str]]         # (t, event, node)
    pu_busy: Dict[str, float]
    dispatches: int = 0
    redispatches: int = 0
    failures: int = 0

    def utilization(self, pu: str) -> float:
        return self.pu_busy.get(pu, 0.0) / max(self.makespan, 1e-9)


Observer = Callable[[float, str, "Node"], None]


class Simulator:
    def __init__(self, gt: GroundTruthPerf, scheduler: HeroScheduler,
                 straggler_prob: float = 0.0, straggler_slow: float = 4.0,
                 fail_prob: float = 0.0, seed: int = 0,
                 observer: Optional[Observer] = None):
        self.gt = gt
        self.sched = scheduler
        self.rng = np.random.default_rng(seed)
        self.straggler_prob = straggler_prob
        self.straggler_slow = straggler_slow
        self.fail_prob = fail_prob
        # streaming hook: (sim time, "start"|"done"|"redispatch", node) —
        # what HeroSession's per-query callbacks attach to
        self.observer = observer

    def _note(self, timeline, t: float, event: str, node: Node):
        timeline.append((t, event, node.id))
        if self.observer is not None:
            self.observer(t, event, node)
        # a fused (cross-query coalesced) dispatch is every member's
        # lifecycle event too: per-query timelines and streaming callbacks
        # see member ids, not the synthetic fused id.  A decode-round
        # boundary is "done" only for members that left; residents that
        # merely advanced emit a token-group "tokens" event instead.
        is_round = bool(node.payload.get("decode_round"))
        for m in node.payload.get("members", ()):
            ev = event
            if is_round and event == EV_DONE and m.status != DONE:
                ev = EV_TOKENS
            self._note(timeline, t, ev, m)

    # -- main loop -----------------------------------------------------------
    def run(self, dag: DynamicDAG, max_time: float = 3600.0) -> SimResult:
        t = 0.0
        active: Dict[str, ActiveTask] = {}       # node id -> task
        pu_free: Dict[str, bool] = {p: True for p in self.sched.pus}
        pu_free.setdefault("io", True)
        busy_acc: Dict[str, float] = {p: 0.0 for p in pu_free}
        timeline: List[Tuple[float, str, str]] = []
        result = SimResult(0.0, timeline, busy_acc)

        def B_total() -> float:
            return sum(a.bandwidth for a in active.values())

        def refresh_rates():
            B = B_total()
            for a in active.values():
                stage = self.gt.stages.get(a.node.stage)
                phi = self.gt.phi(stage, B) if stage is not None else 1.0
                a.rate = 1.0 / phi

        def busy_until(now: float) -> Dict[str, float]:
            # scheduler-visible queue estimates (its own predictions)
            return {a.pu: a.dispatched_at + a.predicted
                    for a in active.values()}

        def dispatch(now: float):
            while True:
                if dag._cancel_pending:
                    self._reap(dag, active, pu_free, timeline, now)
                    refresh_rates()   # aborted tasks left the active set
                idle = [p for p, f in pu_free.items() if f]
                if not idle:
                    return
                decisions = self.sched.dispatch_pass(dag, now, idle,
                                                     B_total(),
                                                     busy_until(now))
                for d in decisions:
                    self._start(d, now, active, pu_free, timeline)
                    result.dispatches += 1
                if decisions:
                    refresh_rates()
                # boundary splits release READY members mid-pass: loop so
                # they can take a still-idle PU at the same instant.  Each
                # split strictly shrinks a fused membership, so this
                # terminates; with preempt off the body runs exactly once.
                if not (self.sched.cfg.preempt and self._apply_preemptions(
                        dag, active, now, timeline)):
                    return

        dispatch(t)
        guard = 0
        while dag.unfinished() and t < max_time:
            guard += 1
            if guard > 200_000:
                raise RuntimeError("simulator livelock")
            if not active:
                if dag._cancel_pending:
                    self._reap(dag, active, pu_free, timeline, t)
                    if not dag.unfinished():
                        break
                # nothing running but work remains: deadlock unless new
                # dispatch succeeds (e.g. after elastic PU change)
                decisions = self.sched.dispatch_pass(
                    dag, t, [p for p, f in pu_free.items() if f], 0.0)
                if not decisions:
                    raise RuntimeError(
                        f"deadlock at t={t:.3f}: "
                        f"{[n.id for n in dag.unfinished()][:6]}")
                for d in decisions:
                    self._start(d, t, active, pu_free, timeline)
                    result.dispatches += 1
                refresh_rates()
                continue
            # next completion event under current rates
            nid, task = min(active.items(),
                            key=lambda kv: kv[1].work_left / kv[1].rate)
            dt = task.work_left / task.rate
            # straggler detection across ALL active tasks: re-dispatch any
            # task whose φ-adjusted ETA is exceeded (capped per node so
            # mispredictions cannot loop)
            spec_nid, dt_spec = None, math.inf
            for anid, a in active.items():
                if a.node.payload.get("redispatches", 0) >= 4:
                    continue
                phi_now = 1.0 / max(a.rate, 1e-6)
                deadline = (a.predicted * phi_now
                            * self.sched.cfg.straggler_factor + 1e-3)
                remaining_to_deadline = deadline - (t - a.dispatched_at)
                will_complete_in = a.work_left / max(a.rate, 1e-12)
                if will_complete_in <= max(remaining_to_deadline, 0.0):
                    continue               # finishes before its deadline
                cand = max(remaining_to_deadline, 0.0)
                if cand < dt_spec:
                    spec_nid, dt_spec = anid, cand
            step = min(dt, dt_spec)
            # advance time
            for a in active.values():
                a.work_left -= step * a.rate
                busy_acc[a.pu] = busy_acc.get(a.pu, 0.0) + step
            t += step
            if dt_spec < dt:
                # speculative re-dispatch: cancel and retry elsewhere
                self._cancel(spec_nid, active, pu_free, timeline, t)
                result.redispatches += 1
                dispatch(t)
                continue
            # completion — mark_done BEFORE emitting "done", mirroring
            # HeroRuntime: observers must see final node state (and fused
            # fan-out metadata) identically on both substrates
            done = active.pop(nid)
            pu_free[done.pu] = True
            prog = done.node.payload.get("on_progress")
            dag.mark_done(nid, t)
            if prog is not None and done.node.kind == "stream_decode":
                prog(dag, done.node, done.node.workload)
            self._note(timeline, t, EV_DONE, done.node)
            refresh_rates()
            dispatch(t)
        result.makespan = dag.makespan()
        return result

    # -- internals -----------------------------------------------------------
    def _start(self, d: Dispatch, now: float, active, pu_free, timeline):
        # io-kind nodes (web calls, admission timers) need no stage model
        stage = self.gt.stages.get(d.node.stage)
        pu = self.gt.soc.pu(d.pu) if d.pu != "io" else None
        # resident decode batches execute at their current width: the
        # ground truth shares the per-step weight sweep across members
        c = Config(d.pu, d.batch,
                   width=(d.node.payload.get("decode_width", 1)
                          if (d.node.payload.get("decode_round")
                              or d.node.payload.get("draft_round"))
                          else 1))
        if d.node.kind == "io":
            # the scheduler's io prediction (0.35 s round trip, or the
            # remaining admission delay for arrival-timer nodes)
            work, bw = d.predicted_p0, 0.0
        else:
            sds = d.node.payload.get("spec_draft_stage")
            if sds is not None and sds in self.gt.stages:
                # speculative verify round: the ground-truth accept rate
                # (not the scheduler's EWMA estimate) decides how many
                # verify sweeps the token group really takes; each sweep
                # scores w+1 positions in one weight pass, pipelined
                # against the draft stream (max) cross-PU or serialized
                # (sum) on a shared PU.  The true pass count is stamped
                # back so boundary accept counters reflect reality.
                w = d.node.payload.get("spec_width", 1)
                dpu = d.node.payload.get("spec_draft_pu", d.pu)
                dsm = self.gt.stages[sds]
                n_true = spec_passes(d.node.workload, w,
                                     self.gt.spec_accept(dsm, stage))
                d.node.payload["spec_passes"] = n_true
                tv = self.gt.spec_verify_p0(stage, pu, w, c.width)
                td = self.gt.p0(dsm, self.gt.soc.pu(dpu),
                                Config(dpu, w, width=c.width))
                work = n_true * (td + tv if dpu == d.pu else max(td, tv))
            else:
                passes = ceil_passes(d.node.workload, d.batch)
                work = passes * self.gt.p0(stage, pu, c)
            bw = self.gt.bandwidth(stage, pu, c)
            if (d.node.kind == "stream_decode"
                    and not d.node.payload.get("draft_round")
                    and self.sched.kv is not None):
                # KV migration is real physics once residency is tracked:
                # streams (round members or a solo token-group chain)
                # whose caches live on another PU pay the ground-truth
                # transfer before the first step (contention scales it
                # like the rest of the work).  The paged tracker gathers
                # page-granularly and may source from the spill tiers
                # ("dram"/"disk" — a fetch, priced by the tier model);
                # tier_transfer_cost is migrate_cost exactly on PU pairs
                migrated = set()
                for m, src, ctx, _by in self.sched.kv.migrate_for_dispatch(
                        d.node, d.pu):
                    sm = self.gt.stages.get(m.stage, stage)
                    work += self.gt.tier_transfer_cost(sm, src, d.pu, ctx)
                    if src in SPILL_TIERS:
                        self._note(timeline, now, EV_KV_FETCH, m)
                    elif m.id not in migrated:
                        # one event per stream per dispatch: a gather from
                        # several PU arenas is still one cache move, so the
                        # timeline matches kv_migrations exactly
                        migrated.add(m.id)
                        self._note(timeline, now, EV_KV_MIGRATE, m)
            if getattr(self.sched.kv, "paged", False):
                # paged KV accounting accrued since the last dispatch:
                # spill transfers (evictions cascading down the tiers) are
                # charged ground-truth seconds to this dispatch — the
                # arena-pressure physics — and page events land on the
                # timeline (kv_page_hit / kv_evict)
                for sname, src, dst, toks in \
                        self.sched.kv.drain_transfers():
                    sm = self.gt.stages.get(sname)
                    if sm is not None:
                        work += self.gt.tier_transfer_cost(sm, src, dst,
                                                           toks)
                # prefetched stagings were issued under a compute-overlap
                # credit: only the ground-truth residual beyond it lands
                # on this dispatch (the min(issue + fetch, round_end)
                # completion model)
                for sname, src, dst, toks, credit in \
                        self.sched.kv.drain_prefetches():
                    sm = self.gt.stages.get(sname)
                    if sm is not None:
                        work += max(0.0, self.gt.tier_transfer_cost(
                            sm, src, dst, toks) - credit)
                for ev, n2 in self.sched.kv.drain_events():
                    self._note(timeline, now, ev, n2)
        # fault injection (admission timers are control nodes — a gated
        # arrival must stay exact under injected faults)
        is_timer = d.node.payload.get("arrival") is not None
        if not is_timer and self.rng.random() < self.straggler_prob:
            work *= self.straggler_slow
        if not is_timer and self.rng.random() < self.fail_prob:
            work *= 1e6  # never completes; straggler detection reaps it
        # dispatch_passes: a decode round's predicted drain is one pass at
        # the current group, same as the live runtime's heartbeat ETA
        # (value-identical to ceil_passes on every non-round dispatch)
        active[d.node.id] = ActiveTask(
            node=d.node, pu=d.pu, batch=d.batch, work_left=work,
            bandwidth=bw, dispatched_at=now,
            # migrate_s: the scheduler's modeled one-off transfer charge —
            # in the ETA so straggler detection and busy_until see the
            # same total the physics above actually pays
            predicted=(d.predicted_p0 * dispatch_passes(d.node, d.batch)
                       + d.migrate_s),
            work_total=work)
        if d.pu != "io":              # io = network, unbounded concurrency
            pu_free[d.pu] = False
        self._note(timeline, now, EV_START, d.node)

    def _apply_preemptions(self, dag: DynamicDAG, active, t,
                           timeline) -> List[Node]:
        """Execute the boundary splits the scheduler flagged
        (``payload["preempt_split"]``): true progress (1 − left/total of
        ground-truth work) picks the member boundary, the released
        members return READY with their state in place, and the kept
        slice's remaining work / ETA shrink proportionally — the
        in-progress member is inside the kept slice by construction, so
        no executed seconds are discarded."""
        released_all: List[Node] = []
        for a in list(active.values()):
            n = a.node
            if not n.payload.pop("preempt_split", False):
                continue
            done_frac = (1.0 - a.work_left / a.work_total
                         if a.work_total > 0 else 0.0)
            w_before = max(n.workload, 1)
            keep = fused_boundary_index(
                [m.workload for m in n.payload["members"]], done_frac)
            released = dag.preempt_fused(n, keep, prefer_pu=a.pu, t=t)
            if not released:
                continue
            scale = max(n.workload, 1) / w_before
            done_s = a.work_total - a.work_left
            a.work_total *= scale
            a.work_left = max(a.work_total - done_s, 0.0)
            a.predicted *= scale
            for m in released:
                self._note(timeline, t, EV_PREEMPT, m)
            released_all.extend(released)
        return released_all

    def _reap(self, dag: DynamicDAG, active, pu_free, timeline, t):
        """Finalize cancel-requested work at a scheduling point: queued
        nodes collapse via ``reap_cancelled``; in-flight flagged tasks
        are aborted (PU freed, node finalized as cancelled) — then one
        more sweep catches successors the aborts just readied."""
        for n in dag.reap_cancelled(t):
            self._note(timeline, t, EV_CANCELLED, n)
        for nid in [k for k, a in active.items()
                    if a.node.payload.get("cancel_requested")]:
            a = active.pop(nid)
            if a.pu != "io":
                pu_free[a.pu] = True
            n = a.node
            n.status, n.finish = DONE, t
            n.expander = None
            n.payload["cancelled"] = True
            if dag.kv is not None and n.kind == "stream_decode":
                dag.kv.release(n)
            for s in dag._succ.get(nid, ()):
                dag._refresh_status(dag.nodes[s])
            self._note(timeline, t, EV_CANCELLED, n)
        if dag._cancel_pending:
            for n in dag.reap_cancelled(t):
                self._note(timeline, t, EV_CANCELLED, n)

    def _cancel(self, nid: str, active, pu_free, timeline, t):
        task = active.pop(nid)
        if task.pu != "io":
            pu_free[task.pu] = True
        n = task.node
        n.status = READY     # back to the pool; scheduler will remap
        n.start, n.config = -1.0, None
        n.payload["redispatches"] = n.payload.get("redispatches", 0) + 1
        self._note(timeline, t, EV_REDISPATCH, n)
