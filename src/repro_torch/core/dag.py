"""Dynamic RAG task graph with partial observability (paper §3.1).

Nodes are *sub-stages*.  The graph evolves at runtime: when a decision
stage finishes, its ``expander`` callback may add new nodes/edges
(G_obs(t) ⊆ G) — e.g. a query rewriter emitting N search sub-queries, or a
search planner spawning web-search + refine branches.  The scheduler only
ever sees the observed graph.

Fused nodes: the dual of sub-stage partitioning.  ``fuse_ready`` merges
several READY same-(stage, kind) nodes — typically the same stage of
*different* admitted queries — into one dispatch unit whose completion
fans back out to every member (``mark_done``), releasing each member's own
successors.  Members leave the ready pool while fused; ``unfuse`` reverses
an un-dispatched fusion.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

PENDING, READY, RUNNING, DONE = "pending", "ready", "running", "done"


def resolve_prefer_pu(kv, members: Sequence["Node"]) -> Optional[str]:
    """The PU a forming decode round should anchor to, from its members'
    ``batch_pu`` history — THE shared resolution: ``fuse_decode`` stamps
    it on the round and the scheduler derives the width cap at it, so
    the two must agree.  Agreement short-circuits (the legacy path);
    conflicting history is resolved by the KV-residency tracker (largest
    resident footprint, deterministic tie-breaks) when one is attached,
    with a smallest-name guard should the tracker ever abstain; without
    a tracker a conflict yields no preference, exactly as before."""
    prev = {m.payload.get("batch_pu") for m in members} - {None}
    if len(prev) == 1:
        return next(iter(prev))
    if prev and kv is not None:
        return kv.prefer_pu(members) or min(prev)
    return None


@dataclass
class Node:
    id: str
    stage: str                       # perf-model key (StageModel name)
    kind: str                        # batchable | stream_prefill | stream_decode | search | io
    workload: int                    # L: items (batchable) / tokens (stream)
    deps: Set[str] = field(default_factory=set)
    # template stage id for the future-criticality prior
    template: Optional[str] = None
    # called on completion; may mutate the DAG (dynamic dependencies)
    expander: Optional[Callable[["DynamicDAG", "Node"], None]] = None
    # partitioning: sub-stages created from this node share its group
    group: Optional[str] = None
    # --- runtime state ---
    status: str = PENDING
    config: Optional[Any] = None     # chosen (pu, batch)
    start: float = -1.0
    finish: float = -1.0
    remaining: float = 0.0           # simulator bookkeeping
    criticality: float = 0.0
    payload: Dict[str, Any] = field(default_factory=dict)


class DynamicDAG:
    def __init__(self):
        self.nodes: Dict[str, Node] = {}
        self._succ: Dict[str, Set[str]] = {}
        self._ids = itertools.count()
        # KV-residency tracker (core/kv_residency.py), attached by the
        # scheduler when SchedulerConfig.kv_residency is on: decode-round
        # boundaries report served tokens / leaves to it, and fuse_decode
        # consults it to anchor rounds with conflicting batch_pu history
        self.kv = None
        # speculative-decoding accept tracker (core/spec_decode.py),
        # attached by the scheduler when SchedulerConfig.spec_decode is
        # on: round boundaries report per-member drafted/accepted counts
        # so the next round's pricing sees each stream's observed alpha
        self.spec = None
        # count of cancel-requested, not-yet-finalized nodes: backends
        # skip the reap scan entirely while it is zero (the hot-path
        # guard that keeps cancellation free when unused)
        self._cancel_pending = 0

    # -- construction -------------------------------------------------------
    def add(self, node: Node) -> Node:
        assert node.id not in self.nodes, node.id
        self.nodes[node.id] = node
        self._succ.setdefault(node.id, set())
        for d in node.deps:
            assert d in self.nodes, f"dep {d} of {node.id} not materialized"
            self._succ.setdefault(d, set()).add(node.id)
        self._refresh_status(node)
        return node

    def fresh_id(self, prefix: str) -> str:
        return f"{prefix}#{next(self._ids)}"

    def add_edge(self, src: str, dst: str):
        self.nodes[dst].deps.add(src)
        self._succ.setdefault(src, set()).add(dst)
        self._refresh_status(self.nodes[dst])

    def retarget_dep(self, node_id: str, old_dep: str, new_dep: str):
        """Replace one dependency of ``node_id`` (chunked-prefill chains)."""
        n = self.nodes[node_id]
        n.deps.discard(old_dep)
        self._succ.get(old_dep, set()).discard(node_id)
        self.add_edge(new_dep, node_id)

    # -- state --------------------------------------------------------------
    def _refresh_status(self, node: Node):
        if node.status in (RUNNING, DONE):
            return
        if all(self.nodes[d].status == DONE for d in node.deps):
            node.status = READY
        else:
            node.status = PENDING

    def ready(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.status == READY]

    def running(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.status == RUNNING]

    def unfinished(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.status != DONE]

    def successors(self, nid: str) -> List[Node]:
        return [self.nodes[s] for s in self._succ.get(nid, ())]

    def mark_running(self, nid: str, t: float, config):
        n = self.nodes[nid]
        n.status, n.start, n.config = RUNNING, t, config

    def mark_done(self, nid: str, t: float):
        n = self.nodes[nid]
        n.status, n.finish = DONE, t
        members = n.payload.get("members")
        if n.payload.get("decode_round"):
            # continuous decode batching: one token-group boundary
            self._finish_decode_round(n, t)
        elif members:
            # coalesced dispatch: completion fans out to every member query
            total = max(n.workload, 1)
            for m in members:
                m.start, m.config = n.start, n.config
                m.payload.pop("fused_into", None)
                m.payload["coalesced"] = n.id
                m.payload["fused_share"] = m.workload / total
                self.mark_done(m.id, t)
        if (getattr(self.kv, "paged", False)
                and n.kind == "stream_prefill"):
            # paged KV: a finished prefill materializes its prefix pages on
            # the PU that ran it (reusing resident hashed pages — the
            # cross-query hit) and links them to its decode stream
            self.kv.on_prefill_done(
                n, n.config[0] if n.config is not None else None)
        # dynamic dependencies: expansion happens *before* dependents are
        # released, so newly-created upstream work is observed atomically
        if n.expander is not None:
            n.expander(self, n)
            n.expander = None
        if (self.kv is not None and n.kind == "stream_decode"
                and not n.payload.get("decode_round")
                and not n.payload.get("draft_round")
                and "members" not in n.payload):
            # a finished decode piece with no continuation (no rest
            # sibling of the same stream) ends its stream: free the KV
            # footprint so long-lived serving does not accumulate ghosts
            skey = n.group or n.id
            if not any(s.kind == "stream_decode"
                       and (s.group or s.id) == skey
                       for s in self.successors(nid)):
                self.kv.on_boundary(n, "", 0, left=True)
        for s in self._succ.get(nid, ()):
            self._refresh_status(self.nodes[s])
        if ((n.payload.get("decode_round")
             or n.payload.get("draft_round"))
                and not self._succ.get(nid)):
            # a completed round nobody depends on (progressive spawns may
            # anchor on it) would otherwise accumulate one node per
            # token-group boundary, making every scheduler pass scan an
            # ever-growing graph in long-lived continuous serving
            del self.nodes[nid]
            self._succ.pop(nid, None)

    # -- continuous decode batching ------------------------------------------
    def fuse_decode(self, members: Sequence[Node]) -> Node:
        """Fuse ≥ 2 READY ``stream_decode`` nodes into one *decode round* —
        one token-group boundary of a resident continuous batch.  Unlike
        ``fuse_ready``, the round does not consume its members whole: its
        workload is the batch's remaining horizon (the scheduler trims it to
        the chosen token group at dispatch) and ``mark_done`` advances every
        member by its slice, releasing finished members immediately (leave)
        while unfinished members rejoin the ready pool to re-fuse at the
        next boundary — where newly READY decode streams join."""
        assert len(members) >= 2
        stage = members[0].stage
        for m in members:
            assert m.status == READY, (m.id, m.status)
            assert m.kind == "stream_decode", m.id
            assert m.stage == stage, m.id
        fused = Node(id=self.fresh_id(f"dround:{stage}"), stage=stage,
                     kind="stream_decode",
                     workload=max(m.workload for m in members),
                     payload={"members": list(members), "decode_round": True,
                              "decode_width": len(members),
                              # sorted member remainders: the horizon
                              # policy picks the round's token group from
                              # this distribution (ragged tails leave at a
                              # boundary instead of being padded to one)
                              "remaining": sorted(m.workload
                                                  for m in members)})
        # KV caches of a resident batch live on the PU that served the
        # previous round; the scheduler charges migration when moving
        prefer = resolve_prefer_pu(self.kv, members)
        if prefer is not None:
            fused.payload["prefer_pu"] = prefer
        for m in members:
            m.status = RUNNING
            m.payload["fused_into"] = fused.id
            m.payload.setdefault(
                "decode_total", m.payload.get("decode_served", 0) + m.workload)
        self.add(fused)
        fused.criticality = max(m.criticality for m in members)
        return fused

    def _finish_decode_round(self, n: Node, t: float):
        """Boundary-quantized fan-out: each member advances by
        ``min(round group, remaining)`` tokens.  Finished members *leave*
        (marked done — successors release, expanders run — the per-member
        early release); the rest return to READY with the served tokens
        subtracted, carrying their progressive-release callbacks."""
        g = max(n.workload, 1)
        members = n.payload["members"]
        dur = (t - n.start) if n.start >= 0 else 0.0
        total = sum(min(g, m.workload) for m in members)
        # speculative round: the same boundary served the same tokens, but
        # in spec_passes verify sweeps of drafted groups.  Per member the
        # round drafted passes × width candidates; accepted counts come
        # from the backend's scoreboard (payload["spec_accepts"], live
        # stage fns) or fall back to the pass arithmetic — s tokens in
        # spec_passes sweeps means s − passes drafts were accepted.
        spec_w = n.payload.get("spec_width", 0)
        spec_n = max(int(n.payload.get("spec_passes", 1)), 1)
        acc_map = n.payload.get("spec_accepts") or {}
        for m in members:
            s = min(g, m.workload)
            m.payload.pop("fused_into", None)
            m.payload["coalesced"] = n.id
            m.payload["last_slice"] = s
            m.payload["decode_rounds"] = m.payload.get("decode_rounds", 0) + 1
            m.payload["decode_served"] = m.payload.get("decode_served", 0) + s
            if spec_w:
                drafted = spec_n * spec_w
                acc = acc_map.get(m.id)
                if acc is None:
                    acc = s - spec_n
                acc = max(0, min(int(acc), drafted))
                m.payload["spec_drafted"] = (
                    m.payload.get("spec_drafted", 0) + drafted)
                m.payload["spec_accepted"] = (
                    m.payload.get("spec_accepted", 0) + acc)
                if self.spec is not None:
                    self.spec.observe(m.group or m.id, drafted, acc)
            if self.kv is not None:
                if n.config is not None:
                    # residency boundary event: the member's cache grew by
                    # the served slice on the round's PU; leavers free theirs
                    self.kv.on_boundary(m, n.config[0], s,
                                        left=(s >= m.workload))
                    if (spec_w and s < m.workload
                            and getattr(self.kv, "paged", False)):
                        # draft KV: a staying member's draft-model cache
                        # mirrors its (just-grown) verify context —
                        # growing forward or trimming the rejected
                        # speculative tail back to it, never below, so
                        # rollback cannot cross a served-page boundary.
                        # Leavers skip: release() frees both footprints.
                        self.kv.spec_draft_sync(
                            m, n.payload.get("spec_draft_stage"),
                            n.payload.get("spec_draft_pu") or n.config[0])
                elif s >= m.workload:
                    # a leaver of an un-configured round (e.g. drained
                    # without a dispatch) must still release its stream, or
                    # its footprint stays registered until session end
                    self.kv.release(m)
            if n.config is not None:
                # PU occupancy charged by live membership: workload share of
                # this round's residency
                acc = m.payload.setdefault("pu_busy_acc", {})
                acc[n.config[0]] = (acc.get(n.config[0], 0.0)
                                    + dur * (s / max(total, 1)))
                m.payload["batch_pu"] = n.config[0]
            if m.start < 0:
                m.start = n.start       # joined the resident batch here
            prog = m.payload.get("on_progress")
            if s >= m.workload:
                m.config = m.config if m.config is not None else n.config
                m.payload["round_final"] = True
                self.mark_done(m.id, t)
                if prog is not None:
                    prog(self, m, s)
            else:
                m.workload -= s
                m.status = READY
                if prog is not None:
                    # spawned work may depend on the (done) round node
                    prog(self, n, s)

    # -- cross-query coalescing ----------------------------------------------
    def fuse_ready(self, members: Sequence[Node]) -> Node:
        """Merge ≥ 2 READY nodes sharing (stage, kind) into one fused
        dispatch unit.  Members are absorbed (status RUNNING, no config)
        until the fused node completes; its ``mark_done`` fans completion
        back out, so each member's successors release normally."""
        assert len(members) >= 2
        stage, kind = members[0].stage, members[0].kind
        for m in members:
            assert m.status == READY, (m.id, m.status)
            assert (m.stage, m.kind) == (stage, kind), m.id
        fused = Node(id=self.fresh_id(f"fused:{stage}"), stage=stage,
                     kind=kind, workload=sum(m.workload for m in members),
                     payload={"members": list(members)})
        for m in members:
            m.status = RUNNING
            m.payload["fused_into"] = fused.id
        self.add(fused)
        fused.criticality = max(m.criticality for m in members)
        return fused

    def preempt_fused(self, fused: Node, keep: int,
                      prefer_pu: Optional[str] = None,
                      t: float = 0.0) -> List[Node]:
        """Split a RUNNING fused batchable dispatch at a member boundary:
        the first ``keep`` members stay in the (truncated) dispatch and
        complete with it; the rest are *released* — back to READY with
        their state in place, stamped ``preemptions`` (+1),
        ``preempt_prefer_pu`` (the PU they were split off, which
        re-placement anchors to unless the KV tracker knows better) and
        ``preempt_t`` (release time ``t`` — the SLO deferral floor's
        clock restarts here, so a released batch member queues a full
        deferral window again instead of re-dispatching into the very
        contention it was split to relieve).
        Nothing is discarded: the in-progress member finishes inside the
        kept slice, so preemption costs only the released members' wait.
        Returns the released members (empty when the boundary falls past
        the last member — the dispatch simply runs out)."""
        assert fused.status == RUNNING, fused.status
        members = fused.payload["members"]
        keep = max(1, min(keep, len(members)))
        if keep >= len(members):
            return []
        kept, released = members[:keep], members[keep:]
        fused.payload["members"] = kept
        fused.workload = sum(m.workload for m in kept)
        for m in released:
            m.status = READY
            m.payload.pop("fused_into", None)
            m.payload["preemptions"] = m.payload.get("preemptions", 0) + 1
            m.payload["preempt_t"] = t
            if prefer_pu is not None:
                m.payload["preempt_prefer_pu"] = prefer_pu
        return released

    # -- user-requested cancellation -------------------------------------------
    def request_cancel(self, prefix: str) -> int:
        """Flag every unfinished node of an admitted query (id prefix)
        for cancellation.  Finalization is deferred to the backend's
        next scheduling point (``reap_cancelled`` + in-flight abort) so
        both substrates observe cancellation at the same granularity.
        Returns the number of nodes flagged."""
        flagged = 0
        for n in self.nodes.values():
            if (n.status != DONE and n.id.startswith(prefix)
                    and not n.payload.get("cancel_requested")):
                n.payload["cancel_requested"] = True
                flagged += 1
        self._cancel_pending += flagged
        return flagged

    def reap_cancelled(self, t: float) -> List[Node]:
        """Finalize cancel-requested PENDING/READY nodes: marked DONE at
        ``t`` with ``payload["cancelled"]`` and their expanders dropped
        (a cancelled query must not spawn new work), decode streams
        release their KV footprint, and successors refresh — so a
        cancelled query's whole remaining chain collapses in one
        fixpoint sweep.  RUNNING nodes are the backend's job (abort the
        in-flight task, then finalize); members absorbed into a live
        fused dispatch ride it to completion first (best-effort — the
        fused work is shared with other queries)."""
        reaped: List[Node] = []
        progress = True
        while progress:
            progress = False
            for n in list(self.nodes.values()):
                if (n.status not in (PENDING, READY)
                        or not n.payload.get("cancel_requested")
                        or "fused_into" in n.payload):
                    continue
                n.status, n.finish = DONE, t
                n.expander = None
                n.payload["cancelled"] = True
                if self.kv is not None and n.kind == "stream_decode":
                    self.kv.release(n)
                for s in self._succ.get(n.id, ()):
                    self._refresh_status(self.nodes[s])
                reaped.append(n)
                progress = True
        self._cancel_pending = sum(
            1 for n in self.nodes.values()
            if n.payload.get("cancel_requested") and n.status != DONE)
        return reaped

    def unfuse(self, fused: Node) -> List[Node]:
        """Dissolve an un-dispatched fused node; members rejoin the ready
        pool."""
        assert fused.status == READY, fused.status
        members = fused.payload["members"]
        for m in members:
            m.status = READY
            m.payload.pop("fused_into", None)
        del self.nodes[fused.id]
        self._succ.pop(fused.id, None)
        return members

    # -- analysis ------------------------------------------------------------
    def topo_order(self) -> List[Node]:
        indeg = {nid: len(n.deps) for nid, n in self.nodes.items()}
        queue = [nid for nid, d in indeg.items() if d == 0]
        out = []
        while queue:
            nid = queue.pop()
            out.append(self.nodes[nid])
            for s in self._succ.get(nid, ()):
                indeg[s] -= 1
                if indeg[s] == 0:
                    queue.append(s)
        assert len(out) == len(self.nodes), "cycle in DAG"
        return out

    def makespan(self) -> float:
        return max((n.finish for n in self.nodes.values()
                    if n.status == DONE), default=0.0)


@dataclass
class WorkflowTemplate:
    """The predefined workflow graph used for the future-criticality term
    CS_F (paper Eq. 4): template stages with activation likelihoods and
    expected downstream workloads, updated from history."""

    stages: Dict[str, "TemplateStage"] = field(default_factory=dict)

    def add_stage(self, sid: str, stage: str, kind: str, mean_workload: float,
                  prob: float, deps: Sequence[str] = ()):
        self.stages[sid] = TemplateStage(sid, stage, kind, mean_workload,
                                         prob, set(deps))

    def descendants(self, sid: str) -> List["TemplateStage"]:
        out, seen = [], set()
        frontier = [sid]
        while frontier:
            cur = frontier.pop()
            for s in self.stages.values():
                if cur in s.deps and s.id not in seen:
                    seen.add(s.id)
                    out.append(s)
                    frontier.append(s.id)
        return out

    def update_history(self, template_id: str, activated: bool,
                       workload: float = 0.0, ema: float = 0.1):
        """Online prior update (historical averages, §4.2)."""
        s = self.stages.get(template_id)
        if s is None:
            return
        s.prob = (1 - ema) * s.prob + ema * (1.0 if activated else 0.0)
        if activated and workload > 0:
            s.mean_workload = (1 - ema) * s.mean_workload + ema * workload


@dataclass
class TemplateStage:
    id: str
    stage: str                 # perf-model key
    kind: str
    mean_workload: float
    prob: float                # historical activation likelihood
    deps: Set[str]
