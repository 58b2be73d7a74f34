"""Shape-aware sub-stage partition (paper §4.2, Eq. 3).

For batchable stages: pick n* = argmin_{n ∈ N_{m,k}} ⌈L/n⌉ · p⁰(n,k) over the
offline-profiled candidate batch set, then split the node into ⌈L/n*⌉
sub-stages of ≤ n* items each (downstream nodes can start as soon as the
sub-stages they actually depend on finish).

For streaming stages: token-group granularity — decode nodes split into
groups of g tokens so downstream stages trigger once their data dependency
(a prefix of the stream) is satisfied.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.core.dag import DONE, READY, DynamicDAG, Node
from repro_torch.core.perf_model import LinearPerfModel

DEFAULT_BATCH_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
DEFAULT_TOKEN_GROUPS = (4, 8, 16, 32)


def ceil_passes(workload: int, batch: int) -> int:
    """⌈L/n⌉ passes of a dispatch at batch n, with the ≥1 floors every
    dispatch site needs — THE shared definition: scheduler ETAs, the
    simulator, and the live runtime must agree on it or their queue
    estimates silently diverge."""
    return -(-max(workload, 1) // max(batch, 1))


def dispatch_passes(node: "Node", batch: int) -> int:
    """Passes ONE dispatch of ``node`` actually executes — the quantity
    straggler ETAs and busy-PU estimates must use.

    A continuous-batching decode round serves exactly one token-group
    boundary per dispatch — one pass, never ⌈horizon/n⌉.  (The round's
    workload normally arrives pre-trimmed to the group, but a round
    re-entering the pool after a live-mode straggler cancellation carries
    a stale trim while its partially-decoded residents have advanced —
    ⌈L/n⌉ over that horizon overestimated the drain and made cancelled
    rounds look slow enough to defer or migrate for no reason.)"""
    if node.payload.get("decode_round"):
        return 1
    return ceil_passes(node.workload, batch)


def fused_boundary_index(workloads: Sequence[int], done_frac: float) -> int:
    """Members to KEEP when splitting a fused dispatch at its next member
    boundary, given the fraction of its total work already executed.

    Members execute in stored order, so the boundary nearest the true
    progress point is the first index whose cumulative workload reaches
    ``done_frac`` of the total — the in-progress member finishes (its
    partial work is never discarded), everything after it is releasable.
    Always keeps at least one member; ``done_frac ≥ 1`` keeps all (the
    dispatch is effectively finished — nothing left to release)."""
    total = sum(max(w, 1) for w in workloads)
    target = min(max(done_frac, 0.0), 1.0) * total
    cum = 0
    for i, w in enumerate(workloads):
        cum += max(w, 1)
        if cum >= target:
            return max(i + 1, 1)
    return max(len(workloads), 1)


def best_batch(perf: LinearPerfModel, stage: str, pu: str, L: int,
               candidates: Sequence[int] = DEFAULT_BATCH_CANDIDATES
               ) -> Tuple[int, float]:
    """Eq. 3: argmin_n ⌈L/n⌉ · p⁰_v((n, k))."""
    best_n, best_t = 1, float("inf")
    for n in candidates:
        if n > L:
            n = L
        t = -(-L // n) * perf.p0(stage, pu, n)
        if t < best_t:
            best_n, best_t = n, t
    return best_n, best_t


def shape_aware_configs(perf: LinearPerfModel, node: Node, pu: str,
                        candidates: Sequence[int] = DEFAULT_BATCH_CANDIDATES,
                        token_groups: Sequence[int] = DEFAULT_TOKEN_GROUPS,
                        cap: Optional[int] = None) -> List[int]:
    """The small candidate config set Alg. 1 enumerates for (v, k).

    ``cap`` bounds the largest batch config enumerated — fused
    (cross-query coalesced) nodes cap at the top of the profiled grid so
    merged dispatches stay on measured shapes."""
    if not perf.supported(node.stage, pu):
        return []
    L = node.workload
    if cap is not None:
        candidates = [c for c in candidates if c <= cap] or [cap]
    if node.kind == "batchable":
        n, _ = best_batch(perf, node.stage, pu, L, candidates)
        # n* plus neighbours lets the mapper trade shape vs contention
        cands = {min(n, L), min(2 * n, L), max(1, n // 2)}
        if cap is not None:
            cands = {min(c, cap) for c in cands}
        return sorted(cands)
    if node.kind == "stream_decode":
        return [min(g, L) for g in token_groups if g <= max(L, 4)][:3] or [L]
    return [L]  # prefill / search / io run whole


def partition_node(dag: DynamicDAG, node: Node, perf: LinearPerfModel,
                   pu: str, candidates: Sequence[int] = DEFAULT_BATCH_CANDIDATES,
                   ) -> List[Node]:
    """Split a batchable node into ⌈L/n*⌉ sub-stages (Eq. 3) for PU ``pu``.

    Successor edges are preserved conservatively (every successor depends on
    every sub-stage) unless the successor is itself partitionable per item —
    the workflow builders create per-item edges where semantics allow
    (e.g. first search need not wait for later rewrites, §3.1)."""
    if node.kind != "batchable" or node.status != READY:
        return [node]
    n_star, _ = best_batch(perf, node.stage, pu, node.workload, candidates)
    if n_star >= node.workload:
        return [node]
    subs: List[Node] = []
    remaining = node.workload
    succ = list(dag.successors(node.id))
    i = 0
    while remaining > 0:
        take = min(n_star, remaining)
        sub = Node(id=dag.fresh_id(f"{node.id}.p"), stage=node.stage,
                   kind=node.kind, workload=take, deps=set(node.deps),
                   template=node.template, group=node.group or node.id)
        dag.add(sub)
        for s in succ:
            dag.add_edge(sub.id, s.id)
        subs.append(sub)
        remaining -= take
        i += 1
    # retire the original node (it was never dispatched)
    node.workload = 0
    node.status = DONE
    node.finish = node.start = 0.0
    for s in succ:
        s.deps.discard(node.id)
        dag._refresh_status(s)
    return subs
