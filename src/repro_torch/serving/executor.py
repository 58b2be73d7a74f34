"""Heterogeneous executors + the real-time HeRo runtime.

``PUExecutor`` is one processing-unit group: a worker thread with a task
queue (on real hardware, one JAX mesh slice / device group; here, CPU
workers).  ``HeroRuntime`` drives a live DynamicDAG through the HeRo
scheduler against wall-clock time — the real-system counterpart of
core/simulator.py — with the fault-tolerance loop the paper-scale
deployment needs:

- heartbeat + straggler mitigation: a task exceeding straggler_factor ×
  the perf-model ETA is speculatively re-dispatched to another PU
  (the slow copy is cancelled cooperatively);
- retry with backoff on executor exceptions;
- elastic membership: PUs may join/leave between dispatch passes
  (scheduler.add_pu / remove_pu) — in-flight work on a lost PU is
  re-queued, which is exactly how a lost pod slice is handled at scale.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.dag import DONE, READY, RUNNING, DynamicDAG, Node
from repro_torch.core.events import (EV_CANCELLED, EV_DONE, EV_KV_FETCH,
                               EV_KV_MIGRATE, EV_PREEMPT, EV_RETRY,
                               EV_START, EV_STRAGGLER, EV_TOKENS,
                               SPILL_TIERS)
from repro_torch.core.partitioner import dispatch_passes, fused_boundary_index
from repro_torch.core.scheduler import Dispatch, HeroScheduler

StageFn = Callable[[Node, int], Any]   # (node, batch) -> result


@dataclass
class _Task:
    node: Node
    batch: int
    fn: StageFn
    started: float = 0.0
    cancelled: bool = False
    result: Any = None
    error: Optional[str] = None
    done_evt: threading.Event = field(default_factory=threading.Event)


class PUExecutor:
    def __init__(self, name: str):
        self.name = name
        self._q: "queue.Queue[_Task]" = queue.Queue()
        self._alive = True
        # queued + running tasks, counted at submit() and released when the
        # worker finishes — guarded by a lock so busy() cannot misreport
        # during the worker's dequeue/complete transitions (an unsynchronized
        # counter let the scheduler double-dispatch a PU)
        self._working = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, task: _Task):
        with self._lock:
            self._working += 1
        self._q.put(task)

    def busy(self) -> bool:
        """True while the worker has queued or running work — including a
        cancelled straggler it cannot preempt (work is non-preemptible;
        the scheduler must route around it)."""
        with self._lock:
            return self._working > 0

    def shutdown(self):
        self._alive = False
        self._q.put(None)  # type: ignore[arg-type]

    def _loop(self):
        while self._alive:
            task = self._q.get()
            if task is None:
                return
            task.started = time.monotonic()
            if not task.cancelled:
                try:
                    task.result = task.fn(task.node, task.batch)
                except Exception:                  # retry handled upstream
                    task.error = traceback.format_exc()
            # release before signalling: once done_evt is visible the PU is
            # genuinely free, so a fresh dispatch must not see busy()==True
            with self._lock:
                self._working -= 1
            task.done_evt.set()


class HeroRuntime:
    """Run one RAG DAG on real executors under the HeRo scheduler."""

    def __init__(self, scheduler: HeroScheduler,
                 executors: Dict[str, PUExecutor],
                 stage_fns: Dict[str, StageFn],
                 max_retries: int = 2,
                 observer: Optional[Callable[[float, str, Node], None]] = None):
        self.sched = scheduler
        self.executors = executors
        self.stage_fns = stage_fns
        self.max_retries = max_retries
        self.results: Dict[str, Any] = {}
        # every event timestamp is run-relative (seconds since run() began),
        # so the list is a usable timeline
        self.events: List[tuple] = []
        self.observer = observer

    def _emit(self, t: float, event: str, node: Node):
        self.events.append((t, event, node.id))
        if self.observer is not None:
            self.observer(t, event, node)
        # fused (cross-query coalesced) dispatches fan events out to their
        # members — same convention as the simulator, so per-query
        # attribution is backend-independent.  At a decode-round boundary,
        # members still resident get a "tokens" event, not "done".
        is_round = bool(node.payload.get("decode_round"))
        for m in node.payload.get("members", ()):
            ev = event
            if is_round and event == EV_DONE and m.status != DONE:
                ev = EV_TOKENS
            self._emit(t, ev, m)

    def add_executor(self, name: str, ex: PUExecutor):
        self.executors[name] = ex
        self.sched.add_pu(name)

    def remove_executor(self, name: str):
        """Elastic scale-down / failure: drop the PU; in-flight work is
        re-queued by the main loop when its heartbeat lapses."""
        self.executors.pop(name, None)
        self.sched.remove_pu(name)

    def run(self, dag: DynamicDAG, poll: float = 0.002,
            timeout: float = 300.0) -> Dict[str, Any]:
        t0 = time.monotonic()
        self._t0 = t0   # run-relative epoch, readable by stage fns (timers)
        inflight: Dict[str, tuple] = {}     # node id -> (_Task, Dispatch, retries)

        def now() -> float:
            return time.monotonic() - t0

        def predicted_total(d: Dispatch) -> float:
            # a dispatch runs ceil(L/batch) passes of p0 each — fused
            # (cross-query coalesced) nodes run whole, so multi-pass
            # dispatches are the norm there, and ETAs must account for it
            # exactly as the simulator does.  Decode rounds serve ONE
            # token group per dispatch: their ETA comes from the
            # remaining tokens at the current group, not the residents'
            # whole horizon (dispatch_passes) — otherwise a cancellation
            # drain overestimates a partially-decoded batch's remaining
            # work and the straggler heartbeat re-reaps it immediately.
            # migrate_s: the modeled one-off KV transfer the dispatch
            # pays first — in the ETA exactly as the simulator counts it
            return (d.predicted_p0 * dispatch_passes(d.node, d.batch)
                    + d.migrate_s)

        def busy_until():
            return {d.pu: d_task.started - t0 + predicted_total(d)
                    for d_task, d, _ in inflight.values()}

        def b_now() -> float:
            return sum(d.bandwidth for _, d, _ in inflight.values())

        def dispatch():
            if dag._cancel_pending:
                # user-requested cancellation, observed at the same
                # granularity as the simulator: queued nodes collapse,
                # in-flight flagged tasks are cancelled cooperatively
                # (the running fn is non-preemptible — it drains
                # off-book, exactly like a cancelled straggler)
                for n in dag.reap_cancelled(now()):
                    self._emit(now(), EV_CANCELLED, n)
                for nid in [k for k, (_tk, dd, _r) in inflight.items()
                            if dd.node.payload.get("cancel_requested")]:
                    tk, dd, _r = inflight.pop(nid)
                    tk.cancelled = True
                    n = dd.node
                    n.status, n.finish = DONE, now()
                    n.expander = None
                    n.payload["cancelled"] = True
                    if dag.kv is not None and n.kind == "stream_decode":
                        dag.kv.release(n)
                    for s in dag._succ.get(nid, ()):
                        dag._refresh_status(dag.nodes[s])
                    self._emit(now(), EV_CANCELLED, n)
                if dag._cancel_pending:
                    for n in dag.reap_cancelled(now()):
                        self._emit(now(), EV_CANCELLED, n)
            # io is unbounded concurrency (network threads), matching the
            # simulator — a sleeping web call or admission timer must not
            # block the io lane for other queries
            busy = {d.pu for _, d, _ in inflight.values() if d.pu != "io"}
            busy |= {name for name, ex in self.executors.items()
                     if ex.busy()}
            idle = [p for p in list(self.executors) + ["io"]
                    if p not in busy]
            for d in self.sched.dispatch_pass(dag, now(), idle, b_now(),
                                              busy_until()):
                self._launch(d, inflight, dag, retries=0, now_t=now())

        dispatch()
        while dag.unfinished():
            if now() > timeout:
                raise TimeoutError("HeroRuntime timed out")
            if not inflight:
                dispatch()
                if not inflight and dag.unfinished():
                    if any(x.busy() for x in self.executors.values()):
                        # cancelled stragglers are non-preemptible: the PU
                        # drains them off-book (not in inflight) and only
                        # then frees up — waiting is progress, not deadlock
                        time.sleep(poll)
                        continue
                    raise RuntimeError(
                        f"deadlock: {[n.id for n in dag.unfinished()][:4]}")
            progressed = False
            for nid in list(inflight):
                task, d, retries = inflight[nid]
                if d.node.payload.pop("preempt_split", False) and \
                        not task.done_evt.is_set() and not task.cancelled:
                    # boundary split flagged by the scheduler: wall-clock
                    # progress against the ETA picks the member boundary;
                    # released members return READY and re-place.  The
                    # running fn is non-preemptible, so on this substrate
                    # the split is bookkeeping (the fn finishes its
                    # original batch; mark_done fans out to kept members
                    # only) — preempt_yield then exempts the shrunken
                    # node from straggler speculation, since its ETA no
                    # longer covers the fn's true remaining work
                    frac = 0.0
                    if task.started:
                        frac = min((time.monotonic() - task.started)
                                   / max(predicted_total(d), 1e-9), 1.0)
                    keep = fused_boundary_index(
                        [m.workload for m in d.node.payload["members"]],
                        frac)
                    released = dag.preempt_fused(d.node, keep,
                                                 prefer_pu=d.pu,
                                                 t=now())
                    if released:
                        d.node.payload["preempt_yield"] = True
                        for m in released:
                            self._emit(now(), EV_PREEMPT, m)
                        progressed = True
                if task.done_evt.is_set():
                    del inflight[nid]
                    progressed = True
                    if task.cancelled:
                        continue
                    if task.error is not None:
                        if retries < self.max_retries:
                            self._emit(now(), EV_RETRY, d.node)
                            self._launch(d, inflight, dag,
                                         retries=retries + 1, now_t=now())
                            continue
                        raise RuntimeError(
                            f"stage {nid} failed:\n{task.error}")
                    if d.node.payload.get("decode_round"):
                        # synthetic per-boundary id: storing under it would
                        # leak one entry per round — fan a coalesce-aware
                        # fn's {member id: result} dict out per query
                        # instead (each member accumulates its rounds)
                        per = (task.result
                               if isinstance(task.result, dict) else {})
                        for m in d.node.payload["members"]:
                            if m.id in per:
                                self.results.setdefault(m.id, []).append(
                                    per[m.id])
                    elif not d.node.payload.get("draft_round"):
                        # draft sub-dispatches get a fresh id per round —
                        # storing their (candidate-token) results would
                        # leak one entry per round; the verify fn is the
                        # one that owes the stream its accepted output
                        self.results[nid] = task.result
                    prog = d.node.payload.get("on_progress")
                    dag.mark_done(nid, now())
                    if prog is not None and d.node.kind == "stream_decode":
                        prog(dag, d.node, d.node.workload)
                    self._emit(now(), EV_DONE, d.node)
                elif task.started and not task.cancelled:
                    # straggler heartbeat (perf-model ETA as the prior, with
                    # a jitter floor and a per-node speculation cap)
                    eta = max(predicted_total(d) *
                              self.sched.cfg.straggler_factor, 0.05)
                    can_spec = (d.node.payload.get("redispatches", 0) < 4
                                and not d.node.payload.get("preempt_yield"))
                    if (can_spec and d.pu in self.executors
                            and time.monotonic() - task.started > eta):
                        task.cancelled = True
                        self._emit(now(), EV_STRAGGLER, d.node)
                        d.node.status = READY
                        d.node.start, d.node.config = -1.0, None
                        d.node.payload["redispatches"] = \
                            d.node.payload.get("redispatches", 0) + 1
                        del inflight[nid]
                        progressed = True
                    elif d.pu not in self.executors:
                        # PU left the fleet: re-queue
                        task.cancelled = True
                        d.node.status = READY
                        d.node.start, d.node.config = -1.0, None
                        del inflight[nid]
                        progressed = True
            if progressed:
                dispatch()
            else:
                time.sleep(poll)
        return self.results

    def _launch(self, d: Dispatch, inflight, dag: DynamicDAG, retries: int,
                now_t: float = 0.0):
        fn = self.stage_fns.get(d.node.stage)
        if d.pu == "io" or fn is None:
            fn = self.stage_fns.get("__io__", lambda n, b: None)
        task = _Task(d.node, d.batch, fn)
        if (d.node.kind == "stream_decode" and self.sched.kv is not None
                and not d.node.payload.get("draft_round")):
            # same registration the simulator does at dispatch start, so
            # kv_migrations / bytes-moved accounting is backend-independent
            # (wall-clock transfer cost is the stage fn's to pay — here it
            # is recorded, not slept).  Paged trackers may gather from the
            # spill tiers: those moves are fetches, not migrations
            migrated = set()
            for m, src, _ctx, _by in self.sched.kv.migrate_for_dispatch(
                    d.node, d.pu):
                if src in SPILL_TIERS:
                    self._emit(now_t, EV_KV_FETCH, m)
                elif m.id not in migrated:
                    # one event per stream per dispatch (multi-arena
                    # gathers are one cache move), matching kv_migrations
                    migrated.add(m.id)
                    self._emit(now_t, EV_KV_MIGRATE, m)
        if getattr(self.sched.kv, "paged", False):
            # paged accounting accrued since the last launch: page events
            # reach the run timeline; spill transfers are recorded in the
            # tracker's counters (wall-clock cost is the executors' to pay)
            self.sched.kv.drain_transfers()
            # prefetched stagings: recorded only (same rule as transfers
            # — the overlapped wall-clock cost is the executors' to pay),
            # keeping both backends' prefetch counters identical
            self.sched.kv.drain_prefetches()
            for ev, n2 in self.sched.kv.drain_events():
                self._emit(now_t, ev, n2)
        if d.node.status != RUNNING:
            dag.mark_running(d.node.id, now_t, (d.pu, d.batch))
        if d.pu == "io":
            threading.Thread(target=lambda: (setattr(
                task, "result", fn(d.node, d.batch)), task.done_evt.set()),
                daemon=True).start()
        else:
            self.executors[d.pu].submit(task)
        inflight[d.node.id] = (task, d, retries)
        self._emit(now_t, EV_START, d.node)
