"""Criticality estimation (paper §4.2, Eq. 4):  CS(v) = CS_L(v) + β·CS_F(v).

CS_L — *observed* term: longest remaining path from v on G_obs(t).  PU
assignment during the path simulation uses a dependency-agnostic SJF-like
heuristic (each node costed at its fastest supported PU), recomputed
whenever G_obs evolves.

CS_F — *future* term: expected downstream work on the predefined workflow
template, weighted by historical activation likelihood.  Agents that tend
to trigger more computation (search planner) get higher expected future
criticality than lightweight post-processing.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.dag import (DONE, RUNNING, DynamicDAG, Node,
                            WorkflowTemplate)
from repro_torch.core.partitioner import best_batch
from repro_torch.core.perf_model import LinearPerfModel


def _sjf_latency(perf: LinearPerfModel, node: Node,
                 cache: Dict[str, float]) -> float:
    """Dependency-agnostic latency prior: fastest PU, shape-optimal (SJF)."""
    key = f"{node.stage}|{node.kind}|{node.workload}"
    if key in cache:
        return cache[key]
    best = float("inf")
    for (stage, pu) in perf.coef:
        if stage != node.stage:
            continue
        if node.kind == "batchable":
            _, t = best_batch(perf, stage, pu, max(node.workload, 1))
        elif node.kind == "stream_decode":
            t = perf.p0(stage, pu, max(node.workload, 1))
        else:
            t = perf.p0(stage, pu, max(node.workload, 1))
        best = min(best, t)
    if best == float("inf"):
        best = 0.35 if node.kind == "io" else 0.0
    cache[key] = best
    return best


def observed_scores(dag: DynamicDAG, perf: LinearPerfModel,
                    now: float) -> Dict[str, float]:
    """CS_L for every unfinished node: longest remaining path on G_obs."""
    cache: Dict[str, float] = {}
    scores: Dict[str, float] = {}
    for node in reversed(dag.topo_order()):
        if node.status == DONE:
            scores[node.id] = 0.0
            continue
        succ_max = max((scores.get(s.id, 0.0)
                        for s in dag.successors(node.id)), default=0.0)
        own = _sjf_latency(perf, node, cache)
        if node.status == RUNNING and node.start >= 0:
            own = max(0.0, own - (now - node.start))
        scores[node.id] = own + succ_max
    return scores


def future_scores(dag: DynamicDAG, template: Optional[WorkflowTemplate],
                  perf: LinearPerfModel) -> Dict[str, float]:
    """CS_F: expected (probability-weighted) downstream template work."""
    if template is None:
        return {}
    cache: Dict[str, float] = {}
    tcost: Dict[str, float] = {}
    for ts in template.stages.values():
        probe = Node(id="probe", stage=ts.stage, kind=ts.kind,
                     workload=max(int(ts.mean_workload), 1))
        tcost[ts.id] = ts.prob * _sjf_latency(perf, probe, cache)
    out: Dict[str, float] = {}
    for node in dag.unfinished():
        if node.template is None or node.template not in template.stages:
            out[node.id] = 0.0
            continue
        # expected work of descendants NOT yet materialized in G_obs
        materialized = {n.template for n in dag.nodes.values()
                        if n.template is not None and n.id != node.id}
        out[node.id] = sum(
            tcost[d.id] for d in template.descendants(node.template)
            if d.id not in materialized)
    return out


def update_criticality(dag: DynamicDAG, perf: LinearPerfModel,
                       template: Optional[WorkflowTemplate], now: float,
                       beta: float = 1.0) -> None:
    """Eq. 4 over R(t) ∪ A(t) (and pending nodes, used for path scores)."""
    cs_l = observed_scores(dag, perf, now)
    cs_f = future_scores(dag, template, perf)
    for node in dag.unfinished():
        node.criticality = cs_l.get(node.id, 0.0) + beta * cs_f.get(node.id,
                                                                    0.0)
