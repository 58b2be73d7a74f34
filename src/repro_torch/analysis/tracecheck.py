"""Happens-before checking over recorded scheduler traces.

``python -m repro_torch.analysis.tracecheck [files...]`` replays recorded
timeline traces (and bench/golden artifacts) through a set of dynamic
invariants the scheduler core must uphold on every run:

- **lifecycle** — each node's event stream obeys the dispatch state
  machine: no serve after completion, no double completion, no
  token-group boundary on a finished stream, redispatch/preempt only on
  live work;
- **PU serialization** — a physical PU serves one dispatch unit at a
  time: recorded serve intervals on the same PU never overlap ("io" is
  exempt — network concurrency is unbounded by design);
- **conservation** — run counters equal (or, for drained paged-KV
  telemetry, bound) their timeline event counts, byte totals move only
  with their paired counts, accepted speculative tokens never exceed
  drafted, and no event lands after the recorded makespan.

Three artifact schemas are sniffed from the JSON shape:

- ``{"schema": "repro_torch.trace/v1", "events": ...}`` — full traces
  recorded by ``--record`` (all rules);
- ``{"regimes": ...}`` — bench-smoke artifacts
  (``benchmarks/baselines/serving_*.json``, ``BENCH_serving.json``):
  per-row sanity (finite, non-negative, p50 ≤ p99 ≤ total,
  accepted ≤ drafted);
- flat ``{name: float | [float]}`` — the PR 2/PR 3 makespan goldens:
  finite and positive.

``--record [DIR]`` re-runs the deterministic scenarios behind the
committed ``tests/goldens/trace_*.json`` files and rewrites them; run it
when an intentional behavior change shifts the traces.
"""
from __future__ import annotations

import glob
import json
import math
import os
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.events import (ALL_EVENTS, EV_CANCELLED, EV_DONE, EV_PREEMPT,
                               EV_REDISPATCH, EV_RETRY, EV_START,
                               EV_STRAGGLER, EV_TOKENS, REDISPATCH_EVENTS)

TRACE_SCHEMA = "repro_torch.trace/v1"
EPS = 1e-9

# counters emitted directly onto the timeline, exactly once per count
EXACT_COUNTERS = {
    "dispatches": (EV_START,),
    "redispatches": REDISPATCH_EVENTS,
    "preemptions": (EV_PREEMPT,),
    "kv_migrations": ("kv_migrate",),
    "kv_fetches": ("kv_fetch",),
}
# paged-KV telemetry reaches the timeline via drain_events() at the
# *next* dispatch: counts accrued after the last dispatch stay
# counter-only, so the event count is a lower bound (with a zero pair:
# no counts, no events)
DRAINED_COUNTERS = {
    "kv_page_hits": "kv_page_hit",
    "kv_evictions": "kv_evict",
    "kv_hit_declined": "kv_hit_declined",
    "kv_soft_overflows": "kv_soft_overflow",
    "kv_prefetches": "kv_prefetch",
}
# byte totals that must move together with their count
BYTE_PAIRS = (("kv_migrations", "kv_bytes_moved"),
              ("kv_fetches", "kv_fetched_bytes"),
              ("kv_evictions", "kv_evicted_bytes"),
              ("kv_prefetches", "kv_prefetch_bytes"))


@dataclass(frozen=True)
class TraceViolation:
    path: str
    rule: str
    where: str       # node id / PU / counter the violation anchors to
    message: str

    def __str__(self) -> str:
        return f"{self.path}: {self.rule} [{self.where}] {self.message}"


# -- full traces -------------------------------------------------------------
# lifecycle states: IDLE (never dispatched), LIVE (dispatched / resident,
# may serve again), FINAL (done or cancelled — terminal)
IDLE, LIVE, FINAL = "idle", "live", "final"


def _check_lifecycle(events, path: str) -> List[TraceViolation]:
    out: List[TraceViolation] = []
    state: Dict[str, str] = {}
    final_ev: Dict[str, str] = {}

    def bad(nid, rule, msg):
        out.append(TraceViolation(path, rule, nid, msg))

    for t, ev, nid in events:
        st = state.get(nid, IDLE)
        if ev == EV_START:
            if st == FINAL:
                bad(nid, "TR101",
                    f"serve after completion: 'start' at t={t:.6g} but the "
                    f"node already finalized via {final_ev[nid]!r}")
            state[nid] = LIVE
        elif ev == EV_TOKENS:
            if st == FINAL:
                bad(nid, "TR102",
                    f"token-group boundary at t={t:.6g} on a finished "
                    "stream")
            elif st == IDLE:
                bad(nid, "TR103",
                    f"token-group boundary at t={t:.6g} on a never-"
                    "dispatched stream")
        elif ev == EV_DONE:
            if st == FINAL:
                bad(nid, "TR104",
                    f"double completion: 'done' at t={t:.6g} after "
                    f"{final_ev[nid]!r}")
            elif st == IDLE:
                bad(nid, "TR105",
                    f"'done' at t={t:.6g} without any 'start'")
            state[nid], final_ev[nid] = FINAL, ev
        elif ev == EV_CANCELLED:
            # queued (never-dispatched) work may be reaped: IDLE is legal
            if st == FINAL:
                bad(nid, "TR104",
                    f"double completion: 'cancelled' at t={t:.6g} after "
                    f"{final_ev[nid]!r}")
            state[nid], final_ev[nid] = FINAL, ev
        elif ev in REDISPATCH_EVENTS or ev == EV_PREEMPT:
            if st == FINAL:
                bad(nid, "TR106",
                    f"{ev!r} at t={t:.6g} on a finished node")
            elif st == IDLE:
                bad(nid, "TR107",
                    f"{ev!r} at t={t:.6g} on a never-dispatched node")
            # node returns to the ready pool; it may start again
        # kv_* events carry no lifecycle constraint: pages of a stream
        # move on cache pressure regardless of the owner's state
    return out


def _check_pu_serialization(dispatches, path: str) -> List[TraceViolation]:
    out: List[TraceViolation] = []
    by_pu: Dict[str, List[dict]] = {}
    for d in dispatches:
        if d["t1"] < d["t0"] - EPS:
            out.append(TraceViolation(
                path, "TR201", d["node"],
                f"dispatch interval ends before it starts "
                f"({d['t0']:.6g} -> {d['t1']:.6g})"))
        if d["pu"] != "io":     # io = network, unbounded concurrency
            by_pu.setdefault(d["pu"], []).append(d)
    for pu, ds in by_pu.items():
        ds.sort(key=lambda d: (d["t0"], d["t1"]))
        for prev, cur in zip(ds, ds[1:]):
            if cur["t0"] < prev["t1"] - EPS:
                out.append(TraceViolation(
                    path, "TR202", pu,
                    f"double-serve: {prev['node']!r} "
                    f"[{prev['t0']:.6g}, {prev['t1']:.6g}] overlaps "
                    f"{cur['node']!r} [{cur['t0']:.6g}, {cur['t1']:.6g}] "
                    f"on {pu}"))
    return out


def _check_conservation(doc, path: str) -> List[TraceViolation]:
    out: List[TraceViolation] = []
    events = doc["events"]
    counters = doc.get("counters", {})
    makespan = float(doc.get("makespan", math.inf))
    n_ev: Dict[str, int] = {}
    for _t, ev, _nid in events:
        n_ev[ev] = n_ev.get(ev, 0) + 1

    for t, ev, nid in events:
        if ev not in ALL_EVENTS:
            out.append(TraceViolation(
                path, "TR301", nid, f"unknown event name {ev!r}"))
        if t < -EPS or t > makespan + EPS:
            out.append(TraceViolation(
                path, "TR302", nid,
                f"event {ev!r} at t={t:.6g} outside [0, makespan="
                f"{makespan:.6g}]"))
    prev_t = -math.inf
    for t, ev, nid in events:
        if t < prev_t - EPS:
            out.append(TraceViolation(
                path, "TR303", nid,
                f"timeline goes backwards: {ev!r} at t={t:.6g} after "
                f"t={prev_t:.6g}"))
        prev_t = max(prev_t, t)

    for name, evs in EXACT_COUNTERS.items():
        if name not in counters:
            continue
        got = sum(n_ev.get(e, 0) for e in evs)
        if counters[name] != got:
            out.append(TraceViolation(
                path, "TR304", name,
                f"counter {name}={counters[name]} but the timeline has "
                f"{got} {'/'.join(evs)} event(s)"))
    for name, ev in DRAINED_COUNTERS.items():
        if name not in counters:
            continue
        got = n_ev.get(ev, 0)
        if got > counters[name]:
            out.append(TraceViolation(
                path, "TR305", name,
                f"{got} {ev!r} events exceed counter {name}="
                f"{counters[name]}"))
        if counters[name] == 0 and got:
            out.append(TraceViolation(
                path, "TR305", name,
                f"{got} {ev!r} event(s) with counter {name}=0"))

    for k, v in counters.items():
        if isinstance(v, (int, float)) and (not math.isfinite(v) or v < 0):
            out.append(TraceViolation(
                path, "TR306", k, f"counter {k}={v!r} is not a finite "
                "non-negative number"))
    for cnt, byt in BYTE_PAIRS:
        if counters.get(cnt, 0) == 0 and counters.get(byt, 0.0) > 0.0:
            out.append(TraceViolation(
                path, "TR307", byt,
                f"{byt}={counters[byt]} moved with {cnt}=0"))
    if counters.get("accepted_tokens", 0) > counters.get("drafted_tokens", 0):
        out.append(TraceViolation(
            path, "TR308", "accepted_tokens",
            f"accepted_tokens={counters['accepted_tokens']} exceeds "
            f"drafted_tokens={counters.get('drafted_tokens', 0)}"))

    for pu, busy in doc.get("pu_busy", {}).items():
        if busy < -EPS or busy > makespan + EPS:
            out.append(TraceViolation(
                path, "TR309", pu,
                f"pu_busy[{pu}]={busy:.6g} outside [0, makespan="
                f"{makespan:.6g}]"))
    return out


def _check_full_trace(doc, path: str) -> List[TraceViolation]:
    events = [tuple(e) for e in doc.get("events", ())]
    out = _check_lifecycle(events, path)
    out += _check_pu_serialization(doc.get("dispatches", ()), path)
    out += _check_conservation(doc, path)
    return out


# -- bench artifacts ---------------------------------------------------------
def _check_bench(doc, path: str) -> List[TraceViolation]:
    out: List[TraceViolation] = []
    for regime, systems in doc.get("regimes", {}).items():
        for sysname, row in systems.items():
            where = f"{regime}/{sysname}"
            if not isinstance(row, dict):
                continue
            for k, v in row.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if not math.isfinite(v) or v < 0:
                    out.append(TraceViolation(
                        path, "BN301", where,
                        f"{k}={v!r} is not finite and non-negative"))
            p50, p99 = row.get("p50"), row.get("p99")
            total = row.get("total")
            if p50 is not None and p99 is not None and p50 > p99 + EPS:
                out.append(TraceViolation(
                    path, "BN302", where, f"p50={p50:.6g} > p99={p99:.6g}"))
            if p99 is not None and total is not None and p99 > total + EPS:
                out.append(TraceViolation(
                    path, "BN302", where,
                    f"p99={p99:.6g} > total makespan {total:.6g}"))
            if row.get("accepted", 0) > row.get("drafted", 0) + EPS:
                out.append(TraceViolation(
                    path, "BN303", where,
                    f"accepted={row['accepted']} exceeds "
                    f"drafted={row.get('drafted', 0)}"))
            rate, toks = row.get("decode_tok_rate"), row.get("decode_tokens")
            if rate is not None and toks is not None and total:
                # tokens/sec over the run can't exceed what the recorded
                # token count supports (and must be zero iff no tokens)
                if rate > toks / min(p50 or total, total) + EPS:
                    out.append(TraceViolation(
                        path, "BN304", where,
                        f"decode_tok_rate={rate:.6g} impossible for "
                        f"{toks} tokens in {total:.6g}s"))
                if (rate == 0) != (toks == 0):
                    out.append(TraceViolation(
                        path, "BN304", where,
                        f"decode_tok_rate={rate:.6g} with "
                        f"decode_tokens={toks}"))
    return out


# -- flat makespan goldens ---------------------------------------------------
def _check_flat(doc, path: str) -> List[TraceViolation]:
    out: List[TraceViolation] = []

    def chk(key, v):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            return
        if not math.isfinite(v) or v <= 0:
            out.append(TraceViolation(
                path, "GL301", key,
                f"makespan {v!r} is not finite and positive"))

    for key, v in doc.items():
        if isinstance(v, list):
            for i, x in enumerate(v):
                chk(f"{key}[{i}]", x)
        else:
            chk(key, v)
    return out


def check_trace(doc: Any, path: str = "<trace>") -> List[TraceViolation]:
    """Schema-sniff ``doc`` and run the matching rule set."""
    if not isinstance(doc, dict):
        return [TraceViolation(path, "TR000", "-",
                               f"expected a JSON object, got "
                               f"{type(doc).__name__}")]
    if doc.get("schema") == TRACE_SCHEMA or "events" in doc:
        return _check_full_trace(doc, path)
    if "regimes" in doc:
        return _check_bench(doc, path)
    return _check_flat(doc, path)


# -- recording ---------------------------------------------------------------
class _RecordingBackend:
    """Wraps a backend to capture, alongside its ``BackendRun``, the
    per-PU serve intervals of every *top-level* dispatch unit.  A
    timeline ``start`` is a unit's own iff the node carries a config and
    is not absorbed into a fused parent (members fan out with
    ``fused_into`` still set); the unit closes on its terminal or
    redispatch event."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.dispatches: List[dict] = []

    def execute(self, dag, scheduler, observer=None, timeout=3600.0):
        open_units: Dict[str, tuple] = {}

        def obs(t, ev, node):
            if observer is not None:
                observer(t, ev, node)
            if (ev == EV_START and node.config is not None
                    and "fused_into" not in node.payload):
                open_units[node.id] = (t, node.config[0])
            elif node.id in open_units and ev in (
                    EV_DONE, EV_CANCELLED, EV_REDISPATCH, EV_STRAGGLER,
                    EV_RETRY):
                t0, pu = open_units.pop(node.id)
                self.dispatches.append(
                    {"node": node.id, "pu": pu, "t0": t0, "t1": t})

        return self.inner.execute(dag, scheduler, observer=obs,
                                  timeout=timeout)


def _record_one(label: str, n_queries: int, stagger: float,
                wfs: Sequence[int], slos: Sequence[str] = ("interactive",),
                trace_idx: Optional[Sequence[int]] = None,
                shared_corpus: bool = False, **session_kw) -> dict:
    from repro_torch.api import HeroSession
    from repro_torch.api.options import SessionOptions
    from repro_torch.rag import default_means, sample_traces, shared_corpus_traces

    sample = shared_corpus_traces if shared_corpus else sample_traces
    traces = sample("hotpotqa", max(n_queries, 8), seed=11)
    sess = HeroSession(world="sd8gen4", family="qwen3",
                       means=default_means(traces),
                       options=SessionOptions(**session_kw))
    rec = _RecordingBackend(sess.backend)
    sess.backend = rec
    for qi in range(n_queries):
        ti = trace_idx[qi] if trace_idx is not None else qi
        sess.submit(traces[ti], wf=wfs[qi % len(wfs)],
                    arrival_time=qi * stagger,
                    slo=slos[qi % len(slos)])
    sess.run()
    run = sess.last_run
    counters = {k: v for k, v in vars(run).items()
                if isinstance(v, (int, float)) and k != "makespan"}
    return {"schema": TRACE_SCHEMA, "label": label,
            "world": "sd8gen4", "family": "qwen3",
            "makespan": run.makespan,
            "pu_busy": dict(run.pu_busy),
            "events": [list(e) for e in run.events],
            "dispatches": rec.dispatches,
            "counters": counters}


# deterministic scenarios, one per serving-era subsystem: the baseline
# serial scheduler, continuous decode batching, the paged KV store under
# prefetch + preemption pressure, and speculative decode rounds
SCENARIOS = {
    "trace_pr2_coalesce_off": dict(n_queries=4, stagger=0.25, wfs=(1,),
                                   coalesce=False),
    "trace_pr3_decode_batch": dict(n_queries=4, stagger=0.0, wfs=(1,),
                                   coalesce=True),
    # a shared retrieval corpus gives cross-query prefix page hits;
    # mixed SLO classes under admission + preemption take the split paths
    "trace_pr6_kv_preempt": dict(n_queries=6, stagger=0.2, wfs=(1, 2),
                                 shared_corpus=True,
                                 slos=("batch", "interactive"),
                                 coalesce=True, kv_pages=True,
                                 kv_prefetch=True, preempt=True,
                                 slo_admission=True,
                                 batch_policy="adaptive"),
    "trace_pr9_specdec": dict(n_queries=4, stagger=0.0, wfs=(1,),
                              coalesce=True, spec_decode=True),
}


def record_goldens(out_dir: str) -> List[str]:
    written = []
    for label, kw in SCENARIOS.items():
        doc = _record_one(label, **kw)
        path = os.path.join(out_dir, f"{label}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        written.append(path)
    return written


# -- driver ------------------------------------------------------------------
def _default_paths() -> List[str]:
    root = os.getcwd()
    return sorted(glob.glob(os.path.join(root, "tests", "goldens",
                                         "*.json")))


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--record":
        out_dir = argv[1] if len(argv) > 1 else os.path.join(
            os.getcwd(), "tests", "goldens")
        for path in record_goldens(out_dir):
            print(f"recorded {path}")
        argv = []
    paths = argv or _default_paths()
    if not paths:
        print("repro_torch.analysis.tracecheck: no trace files found",
              file=sys.stderr)
        return 1
    violations: List[TraceViolation] = []
    checked = 0
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            violations.append(TraceViolation(path, "TR000", "-", str(e)))
            continue
        violations.extend(check_trace(doc, path))
        checked += 1
    for v in violations:
        print(v)
    if violations:
        print(f"repro_torch.analysis.tracecheck: {len(violations)} violation(s) "
              f"across {checked} file(s)", file=sys.stderr)
        return 1
    print(f"repro_torch.analysis.tracecheck: OK ({checked} file(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
