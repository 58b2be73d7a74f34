"""Per-query results assembled from a backend run.

The backends execute one shared :class:`DynamicDAG`; this module slices
the node-level record (start/finish/config on every node, plus the event
timeline) back into per-query :class:`QueryResult` views.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.dag import DONE, DynamicDAG
from repro_torch.core.events import EV_START, REDISPATCH_EVENTS

ADMIT_STAGE = "admit"     # session-inserted arrival-timer nodes


@dataclass
class QueryResult:
    qid: int
    workflow: str                       # WorkflowSpec name
    backend: str
    arrival_time: float
    finish_time: float                  # run-relative completion of last node
    makespan: float                     # finish_time - arrival_time
    stage_latency: Dict[str, float] = field(default_factory=dict)
    pu_busy: Dict[str, float] = field(default_factory=dict)
    dispatches: int = 0
    redispatches: int = 0
    n_nodes: int = 0
    # nodes of this query that ran inside a cross-query fused dispatch
    coalesced_nodes: int = 0
    # token-group rounds this query's decode streams spent resident in a
    # continuous cross-query decode batch
    decode_rounds: int = 0
    # KV-cache migrations this query's decode streams paid (resident
    # rounds moving PU under kv_residency tracking) and the bytes shipped
    kv_migrations: int = 0
    kv_bytes_moved: float = 0.0
    # spill-tier gathers this query's decode streams paid (pages fetched
    # back from dram/disk at dispatch; zero unless ``kv_pages`` is on)
    kv_fetches: int = 0
    kv_fetched_bytes: float = 0.0
    # paged-KV prefix-cache hits on this query's prefills and the prefill
    # tokens those hits skipped (zero unless ``kv_pages`` is on)
    kv_page_hits: int = 0
    kv_hit_tokens: int = 0
    # prefix hits the hit-or-recompute rule declined on this query's
    # prefills (fetching the demoted pages would have cost more than
    # re-prefilling them)
    kv_hit_declined: int = 0
    # predictive-prefetch staging attributed to this query's nodes (zero
    # unless ``kv_prefetch`` is on): groups issued, bytes staged, and
    # staged pages a later dispatch found already resident
    kv_prefetches: int = 0
    kv_prefetch_bytes: float = 0.0
    kv_prefetch_hits: int = 0
    # SLO class the query was submitted under, its optional latency
    # budget (seconds from arrival), and whether the budget held — None
    # when no deadline was given
    slo_class: str = "interactive"
    deadline: Optional[float] = None
    deadline_met: Optional[bool] = None
    # times this query's nodes were released from a preempted fused
    # dispatch (boundary splits; sums to BackendRun.preemptions across
    # queries on either backend)
    preemptions: int = 0
    # speculative decoding (zero unless ``spec_decode`` is on): draft
    # candidate tokens proposed for this query's decode streams, how many
    # the target model accepted, and the resulting per-query accept rate.
    # Payload-attributed per member at round boundaries, so per-query
    # counts sum to the BackendRun totals on either backend
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    accept_rate: Optional[float] = None
    # the query was withdrawn via QueryHandle.cancel() mid-run (metrics
    # cover only the work that completed before the cancel took effect)
    cancelled: bool = False

    def utilization(self, pu: str) -> float:
        """Fraction of this query's latency window ``pu`` spent on it."""
        return self.pu_busy.get(pu, 0.0) / max(self.makespan, 1e-9)


def collect_results(dag: DynamicDAG, handles, run, backend_name: str
                    ) -> List[QueryResult]:
    """Slice one shared-DAG :class:`BackendRun` into per-query results.

    ``handles``: QueryHandle list (each carries ``qid``/``prefix``/
    ``arrival_time``); nodes and events are attributed by id prefix."""
    out = []
    for h in handles:
        nodes = [n for nid, n in dag.nodes.items()
                 if nid.startswith(h.prefix) and n.stage != ADMIT_STAGE]
        stage_latency: Dict[str, float] = {}
        pu_busy: Dict[str, float] = {}
        finish = h.arrival_time
        coalesced = rounds = kv_migs = page_hits = hit_tokens = 0
        hit_declined = prefetches = prefetch_hits = preempts = 0
        drafted = accepted = fetches = 0
        kv_bytes = prefetch_bytes = fetched_bytes = 0.0
        for n in nodes:
            # preemption releases survive even on nodes a later cancel
            # finalized without running (start < 0)
            preempts += n.payload.get("preemptions", 0)
            if n.status != DONE or n.start < 0:
                continue
            kv_migs += n.payload.get("kv_migrations", 0)
            kv_bytes += n.payload.get("kv_bytes_moved", 0.0)
            fetches += n.payload.get("kv_fetches", 0)
            fetched_bytes += n.payload.get("kv_fetched_bytes", 0.0)
            page_hits += n.payload.get("kv_page_hits", 0)
            hit_tokens += n.payload.get("kv_hit_tokens", 0)
            hit_declined += n.payload.get("kv_hit_declined", 0)
            prefetches += n.payload.get("kv_prefetches", 0)
            prefetch_bytes += n.payload.get("kv_prefetch_bytes", 0.0)
            prefetch_hits += n.payload.get("kv_prefetch_hits", 0)
            drafted += n.payload.get("spec_drafted", 0)
            accepted += n.payload.get("spec_accepted", 0)
            dur = n.finish - n.start
            # stage latency is wall time in the stage; PU busy is charged
            # by workload share when the node rode a fused (coalesced)
            # dispatch, so per-query busy sums match real PU occupancy
            share = n.payload.get("fused_share", 1.0)
            if "coalesced" in n.payload:
                coalesced += 1
            rounds += n.payload.get("decode_rounds", 0)
            stage_latency[n.stage] = stage_latency.get(n.stage, 0.0) + dur
            acc = n.payload.get("pu_busy_acc")
            if acc is not None:
                # continuous-batching member: PU occupancy accrued per
                # round by live membership share, not wall duration (the
                # stream idles between boundaries while others are served)
                for pu, v in acc.items():
                    pu_busy[pu] = pu_busy.get(pu, 0.0) + v
                if (not n.payload.get("round_final")
                        and n.config is not None):
                    # left the resident batch and finished on a solo
                    # dispatch: charge that final stint by wall time
                    pu_busy[n.config[0]] = (pu_busy.get(n.config[0], 0.0)
                                            + dur * share)
            elif n.config is not None:
                pu_busy[n.config[0]] = (pu_busy.get(n.config[0], 0.0)
                                        + dur * share)
            finish = max(finish, n.finish)
        dispatches = redispatches = 0
        admit_id = f"{h.prefix}{ADMIT_STAGE}"
        for t, event, nid in run.events:
            if not nid.startswith(h.prefix) or nid == admit_id:
                continue
            if event == EV_START:
                dispatches += 1
            elif event in REDISPATCH_EVENTS:
                redispatches += 1
        res = QueryResult(
            qid=h.qid, workflow=h.spec.name, backend=backend_name,
            arrival_time=h.arrival_time, finish_time=finish,
            makespan=finish - h.arrival_time, stage_latency=stage_latency,
            pu_busy=pu_busy, dispatches=dispatches,
            redispatches=redispatches, n_nodes=len(nodes),
            coalesced_nodes=coalesced, decode_rounds=rounds,
            kv_migrations=kv_migs, kv_bytes_moved=kv_bytes,
            kv_fetches=fetches, kv_fetched_bytes=fetched_bytes,
            kv_page_hits=page_hits, kv_hit_tokens=hit_tokens,
            kv_hit_declined=hit_declined, kv_prefetches=prefetches,
            kv_prefetch_bytes=prefetch_bytes,
            kv_prefetch_hits=prefetch_hits,
            slo_class=getattr(h, "slo", "interactive"),
            deadline=getattr(h, "deadline", None),
            preemptions=preempts,
            drafted_tokens=drafted, accepted_tokens=accepted,
            cancelled=bool(getattr(h, "cancelled", False)))
        if drafted > 0:
            res.accept_rate = accepted / drafted
        if res.deadline is not None:
            res.deadline_met = res.makespan <= res.deadline
        h.result = res
        out.append(res)
    return out
