"""Per-stream KV-cache residency tracking + modeled migration pricing.

HeRo's decode-round PU stickiness used to be priced by a constant
(``SchedulerConfig.decode_migrate_cost``) — and *solo* decode chains
(a stream served one token group at a time through ``_take_substage``
rest siblings) were not priced at all, hopping PUs freely between
groups.  Both mis-rank PU candidates exactly when context is long and
migration is genuinely expensive.  This module makes KV placement
first-class scheduler state, the way Agent.xpu argues it must be on
heterogeneous SoCs:

- :class:`KVResidency` tracks, per decode *stream* (keyed by
  ``node.group or node.id`` so identity survives both sub-stage
  chaining and round re-fusion), the PU holding its KV cache and the
  context length resident there: the prefill context stamped by the
  workflow spec as ``payload["kv_ctx"]``, grown by decode-round
  boundary events (``DynamicDAG._finish_decode_round`` via the
  ``dag.kv`` hook) and by solo token-group dispatches.
- Moving resident work to another PU is priced by the *modeled*
  migration cost: footprint (ctx × KV-bytes/token) ÷ the profiled
  PU-pair link bandwidth (``LinearPerfModel.migrate_cost``), with the
  shared-memory contention multiplier φ applied since the copy rides
  the same bus as everything else.
- Both backends call :meth:`migrate_for_dispatch` when decode work
  starts, so migrations are counted (and, on the simulator, charged
  ground-truth transfer seconds) identically: ``kv_migrations`` and
  ``kv_bytes_moved`` land on the node payloads for per-query results
  and on the tracker for run totals.

The subsystem is gated by ``SchedulerConfig.kv_residency`` — off, the
scheduler keeps the legacy constant and migration stays free physics,
bit-identical to the PR 2/3/4 goldens.

``core/kv_pages.py`` supersedes this monolithic footprint with a
page-table tracker (tiered store + prefix cache) behind the same
protocol; this class remains the ``kv_residency`` implementation and
the shared vocabulary (``stream_key`` / ``_kv_members``) both use.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.dag import Node
from repro_torch.core.perf_model import LinearPerfModel


def stream_key(n: Node) -> str:
    """Stable identity of the decode stream ``n`` belongs to: sub-stage
    chaining mints fresh node ids per rest piece but preserves ``group``;
    round members keep their node id across boundaries."""
    return n.group or n.id


def _kv_members(node: Node) -> Sequence[Node]:
    """The decode streams a dispatch of ``node`` serves: the members of a
    decode round, the node itself for a solo stream, nothing for fused
    batchable work (no KV)."""
    if node.payload.get("decode_round"):
        return node.payload.get("members", ())
    if node.kind == "stream_decode" and "members" not in node.payload:
        return (node,)
    return ()


@dataclass
class StreamKV:
    """Residency record of one decode stream's KV cache."""

    stage: str
    pu: Optional[str]          # PU holding the cache (None until first serve)
    ctx_tokens: int            # context resident so far (prefill + decoded)
    # solo dispatches whose decoded tokens were already counted into
    # ctx_tokens (idempotency across straggler re-dispatches)
    charged: Set[str] = field(default_factory=set)


class KVResidency:
    """Tracks resident KV footprints per stream / per PU and prices moves.

    One tracker per :class:`HeroScheduler`; the scheduler attaches it to
    the DAG under execution (``dag.kv``) so boundary events reach it from
    either backend.
    """

    def __init__(self, perf: LinearPerfModel):
        self.perf = perf
        self._streams: Dict[str, StreamKV] = {}
        # run totals (BackendRun.kv_migrations / kv_bytes_moved)
        self.migrations = 0
        self.bytes_moved = 0.0

    # -- footprint accounting ------------------------------------------------
    def _ensure(self, m: Node) -> StreamKV:
        key = stream_key(m)
        st = self._streams.get(key)
        if st is None:
            base = (int(m.payload.get("kv_ctx", 0))
                    + int(m.payload.get("decode_served", 0)))
            st = self._streams[key] = StreamKV(stage=m.stage, pu=None,
                                              ctx_tokens=base)
        return st

    def footprint_bytes(self, m: Node) -> float:
        """Resident KV bytes of stream ``m`` (ctx × profiled bytes/token)."""
        st = self._ensure(m)
        return st.ctx_tokens * self.perf.kv_bytes.get(st.stage, 0.0)

    def resident_bytes(self, pu: Optional[str] = None) -> float:
        """Total tracked KV bytes, optionally restricted to one PU."""
        return sum(st.ctx_tokens * self.perf.kv_bytes.get(st.stage, 0.0)
                   for st in self._streams.values()
                   if pu is None or st.pu == pu)

    def tracked(self, m: Node) -> Optional[StreamKV]:
        return self._streams.get(stream_key(m))

    def resident_pu(self, m: Node) -> Optional[str]:
        """The PU holding ``m``'s stream's KV cache right now — the
        anchor preempted-member re-placement prefers (the released
        member's state stayed put).  ``None`` when nothing is tracked."""
        st = self._streams.get(stream_key(m))
        return st.pu if st is not None else None

    # -- placement preference ------------------------------------------------
    def prefer_pu(self, members: Sequence[Node]) -> Optional[str]:
        """The PU holding the largest resident footprint among ``members``
        — the anchor a forming decode round should stick to when member
        histories conflict.  Deterministic: byte totals tie-break by PU
        name (sorted ascending, max wins), never set iteration order."""
        totals: Dict[str, float] = {}
        for m in members:
            st = self._streams.get(stream_key(m))
            pu = (st.pu if st is not None and st.pu is not None
                  else m.payload.get("batch_pu"))
            if pu is None:
                continue
            totals[pu] = totals.get(pu, 0.0) + self.footprint_bytes(m)
        if not totals:
            return None
        return max(sorted(totals), key=lambda p: totals[p])

    # -- migration pricing (Eq. 5 addend) ------------------------------------
    def migrate_penalty(self, node: Node, dst_pu: str,
                        B: float = 0.0) -> Optional[Tuple[int, float]]:
        """``(n_streams_moving, modeled_seconds)`` for serving ``node`` on
        ``dst_pu``: every stream whose cache resides elsewhere pays
        footprint ÷ link-bandwidth, φ-scaled (the copy contends for the
        same bus).  ``None`` when the profile has no migration grid — the
        caller falls back to the legacy constant."""
        moving, cost = 0, 0.0
        for m in _kv_members(node):
            st = self._streams.get(stream_key(m))
            src = (st.pu if st is not None and st.pu is not None
                   else m.payload.get("batch_pu"))
            if src is None or src == dst_pu:
                continue
            ctx = (st.ctx_tokens if st is not None
                   else self._ensure(m).ctx_tokens)
            c = self.perf.migrate_cost(m.stage, src, dst_pu, ctx)
            if c is None:
                return None
            moving += 1
            cost += c
        if moving:
            cost *= self.perf.phi(node.stage, B)
        return moving, cost

    # -- backend hooks -------------------------------------------------------
    def migrate_for_dispatch(self, node: Node, pu: str
                             ) -> List[Tuple[Node, str, int, float]]:
        """Register decode work starting on ``pu`` and return the streams
        whose caches actually move: ``(member, src_pu, ctx_tokens,
        bytes)`` per migration.  Called by BOTH backends at dispatch
        start (simulator charges ground-truth transfer seconds; the live
        runtime emits the events), so counters are backend-independent.
        First serves adopt ``pu`` free of charge — the legacy stickiness
        semantics.  Solo dispatches also grow the stream's context by the
        token group they serve (idempotent per piece, so straggler
        re-dispatches do not double-count)."""
        moved: List[Tuple[Node, str, int, float]] = []
        is_round = bool(node.payload.get("decode_round"))
        for m in _kv_members(node):
            st = self._ensure(m)
            if st.pu is None:
                st.pu = m.payload.get("batch_pu") or pu
            if st.pu != pu:
                by = st.ctx_tokens * self.perf.kv_bytes.get(st.stage, 0.0)
                moved.append((m, st.pu, st.ctx_tokens, by))
                st.pu = pu
                self.migrations += 1
                self.bytes_moved += by
                m.payload["kv_migrations"] = (
                    m.payload.get("kv_migrations", 0) + 1)
                m.payload["kv_bytes_moved"] = (
                    m.payload.get("kv_bytes_moved", 0.0) + by)
            if not is_round and m.id not in st.charged:
                # a solo dispatch decodes its (trimmed) workload here;
                # round members instead grow at the boundary fan-out
                st.charged.add(m.id)
                st.ctx_tokens += max(int(m.workload), 0)
        return moved

    def on_boundary(self, m: Node, pu: str, served: int,
                    left: bool = False) -> None:
        """One decode-round boundary for member ``m``: its cache now holds
        ``served`` more tokens on ``pu``; a member that *left* (finished)
        frees its footprint."""
        if left:
            self.release(m)
            return
        st = self._ensure(m)
        st.pu = pu
        st.ctx_tokens += max(int(served), 0)

    def release(self, m: Node) -> None:
        """Terminal release of ``m``'s stream.  ``mark_done`` calls this
        unconditionally for every finished stream — including members of
        an un-configured round and streams whose final boundary never
        fired — so no stream identity can keep its footprint registered
        until session end (total resident bytes return to zero once every
        stream has finished)."""
        self._streams.pop(stream_key(m), None)

    # -- runtime invariants (REPRO_CHECK=1) ----------------------------------
    def check_quiescent(self) -> None:
        """Assert the release guarantee above actually held: once a run
        drains, no stream is still tracked and total resident bytes are
        back to zero.  Called by both backends at end of run when
        ``REPRO_CHECK=1`` (see ``core/checks.py``)."""
        from repro_torch.core.checks import invariant
        invariant(not self._streams,
                  "KVResidency quiescence: streams still tracked at end "
                  f"of run: {sorted(self._streams)[:6]}")
        invariant(self.resident_bytes() == 0.0,
                  "KVResidency quiescence: resident bytes nonzero at end "
                  f"of run: {self.resident_bytes()}")
