"""Paged KV cache: page-table residency, tiered eviction, prefix reuse.

PR 5's :class:`~repro_torch.core.kv_residency.KVResidency` made KV placement
first-class scheduler state, but tracked each decode stream as ONE
monolithic footprint: migration was all-or-nothing, capacity was
unbounded, and the dominant serving pattern — many queries re-prefilling
the *same* retrieved chunks from a shared corpus — paid full prefill
every time.  This module supersedes the monolith with a page table, the
way vLLM-style paged attention and PerCache's hierarchical on-device
cache organize KV state:

- Each decode stream's cache is a list of fixed-size pages
  (``SchedulerConfig.kv_page_tokens`` tokens; page bytes follow from the
  profiled GQA cache shape, ``LinearPerfModel.kv_bytes``) held in a
  tiered store: PU-local arenas (tier 0), a shared-DRAM spill pool
  (tier 1) and disk (tier 2), with per-tier capacities from the
  profiled ``kv_tiers``.
- Eviction is LRU-with-pin: pages referenced by a live stream
  (``refs > 0``) are never demoted; unpinned prefix-cache pages demote
  down the tiers in last-use order.  When every page is pinned the
  arena soft-overflows (streams are never corrupted to satisfy a
  capacity model).
- Migration is page-granular and priced through the same
  ``link_bandwidth`` model as the monolith: a decode dispatch gathers
  only the pages *not* already on its PU, so partial moves, the
  prefill→first-decode hop and busy-PU ETA migration terms all become
  first-class (PU↔PU hops are ``kv_migrations``/``kv_bytes_moved``,
  spill-tier hops are fetches, priced by the fitted tier lines).
- On top of the table sits a content-hash prefix cache: prefill nodes
  whose token-prefix (retrieved-chunk ids + system/query segments,
  chain-hashed per page boundary) matches resident pages skip that
  prefix's prefill workload (``apply_prefix_hits``), and the resident
  pages are re-referenced for the new stream at prefill completion
  (``on_prefill_done``).

On top of paging sits a **predictive prefetch** layer (PerCache's
hierarchical staging, RAGDoll's fetch/compute overlap): the scheduler's
lookahead hook (``HeroScheduler._prefetch_pass``) calls :meth:`prefetch`
when it commits a round, pre-staging spill-resident pages up the tiers
*during* the committed compute window instead of fetching them on the
dispatch critical path.  Each prefetch carries the overlap credit it was
issued with, so the simulator charges only the residual
(``max(0, fetch_s - credit)`` — the ``min(issue + fetch_s,
prev_round_end)`` completion model).  With prefetch enabled, eviction is
hit-frequency-weighted instead of plain LRU: cold private pages demote
before shared prefix pages that keep earning hits.

Both backends drain the same event/transfer/prefetch queues
(``kv_page_hit`` / ``kv_evict`` / ``kv_prefetch`` / ``kv_soft_overflow``
events; spill transfers priced by the simulator through
``GroundTruthPerf.tier_transfer_cost``), so accounting is
backend-independent.  The subsystem is gated by
``SchedulerConfig.kv_pages`` — off, the scheduler keeps the monolithic
tracker (or none), bit-identical to the PR 2/3/5 goldens — and the
prefetch layer by ``SchedulerConfig.kv_prefetch`` (off = bit-identical
to the PR 6 paging behaviour).
"""
from __future__ import annotations

import hashlib
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.dag import Node
from repro_torch.core.events import (EV_KV_EVICT, EV_KV_HIT_DECLINED,
                               EV_KV_PAGE_HIT, EV_KV_PREFETCH,
                               EV_KV_SOFT_OVERFLOW)
from repro_torch.core.kv_residency import _kv_members, stream_key
from repro_torch.core.perf_model import LinearPerfModel

DRAM, DISK = "dram", "disk"
# stream-key suffix of a speculative draft-model cache mirror: a second,
# smaller footprint per decode stream (see spec_draft_sync / release)
DRAFT_KEY = "#draft"


def decode_stage_of(stage: str) -> str:
    """The decode stage whose profiled KV shape denominates pages produced
    by ``stage`` (``chat_prefill`` fills ``chat_decode``'s cache — the
    builtin specs all follow the ``*_prefill``/``*_decode`` convention)."""
    if stage.endswith("_prefill"):
        return stage[: -len("_prefill")] + "_decode"
    return stage


def decode_stage_for(n: Node) -> str:
    """Resolve the decode stage denominating ``n``'s KV pages: the typed
    ``DecodeSpec`` stamped by ``spec.build_dag`` (``payload["decode_spec"]
    .kv_stage``) wins, then the legacy raw ``payload["kv_decode_stage"]``
    stamp (hand-built nodes), then the ``*_prefill``/``*_decode`` naming
    convention.  Custom specs whose stage names do not follow the
    convention MUST override — paging a prefill under a guessed decode
    shape mischarges every byte it touches (the trap the override
    closes)."""
    spec = n.payload.get("decode_spec")
    kvs = getattr(spec, "kv_stage", None)
    if kvs:
        return str(kvs)
    override = n.payload.get("kv_decode_stage")
    if override:
        return str(override)
    return decode_stage_of(n.stage)


def chain_hash(prev: Optional[str], content: str) -> str:
    """Hash of one page given the chain hash of the pages before it — two
    prefixes share page ``i`` iff they agree on ALL content up to and
    including page ``i``, which is exactly KV-cache validity."""
    h = hashlib.sha1()
    h.update((prev or "").encode())
    h.update(b"\x00")
    h.update(content.encode())
    return h.hexdigest()


def page_keys(segments: Sequence[Tuple[str, int]], page_tokens: int
              ) -> List[Tuple[str, int]]:
    """Split a token-prefix described by ``segments`` (``(content_key,
    tokens)`` in prompt order) at page boundaries: ``[(chain_hash,
    tokens_in_page), ...]``.  A page spanning a segment boundary hashes
    both keys, so e.g. the page mixing shared context with the per-query
    question is (correctly) only reusable by the identical query."""
    pages: List[Tuple[str, int]] = []
    prev: Optional[str] = None
    fill: List[str] = []
    used = 0
    for key, tok in segments:
        tok = int(tok)
        off = 0
        while off < tok:
            take = min(page_tokens - used, tok - off)
            fill.append(f"{key}[{off}:{off + take}]")
            used += take
            off += take
            if used == page_tokens:
                prev = chain_hash(prev, "|".join(fill))
                pages.append((prev, page_tokens))
                fill, used = [], 0
    if used:
        prev = chain_hash(prev, "|".join(fill))
        pages.append((prev, used))
    return pages


@dataclass
class KVPage:
    """One fixed-size page of some stream's KV cache."""

    pid: int
    stage: str                 # decode-stage key (profiled bytes/token)
    tokens: int
    tier: str                  # PU name, "dram", or "disk"
    hash: Optional[str] = None  # content id (prefix-cacheable); None=private
    refs: int = 0              # live streams holding this page (pin)
    last_use: int = 0          # LRU clock
    hits: int = 0              # prefix-cache reuses (frequency weight)
    # speculative draft-model cache page: never pinned (refs stays 0)
    # and evicted before ANY non-draft page in the same arena — draft
    # cache must not push verify pages out
    draft: bool = False


@dataclass
class PagedStream:
    """Page-table record of one decode stream's KV cache."""

    stage: str
    pu: Optional[str]          # anchor PU (None until first serve)
    ctx_tokens: int            # context resident so far (prefill + decoded)
    pages: List[int] = field(default_factory=list)
    # tokens counted in ctx_tokens but not yet backed by pages: a stream
    # seen before any serve has nowhere to live yet — they materialize as
    # private pages on the adopted PU at first dispatch, free of charge
    # (the monolith's first-serve semantics)
    pending: int = 0
    charged: Set[str] = field(default_factory=set)


class PagedKVCache:
    """Page-table KV tracker — a drop-in for :class:`KVResidency` (same
    scheduler/DAG/backend protocol) plus the paged-only hooks
    (``apply_prefix_hits`` / ``on_prefill_done`` / drain queues).
    ``paged`` marks the extended protocol for backends."""

    paged = True

    def __init__(self, perf: LinearPerfModel, page_tokens: int = 64,
                 prefetch: bool = False):
        self.perf = perf
        self.page_tokens = max(int(page_tokens), 1)
        # predictive prefetch + hit-frequency-weighted eviction; off = the
        # PR 6 paging behaviour, bit-identical (plain LRU, no staging)
        self.prefetch_on = bool(prefetch)
        self._streams: Dict[str, PagedStream] = {}
        self._pages: Dict[int, KVPage] = {}
        self._tier_pages: Dict[str, Set[int]] = {}
        self._tier_used: Dict[str, float] = {}
        self._index: Dict[str, int] = {}        # content hash -> pid
        self._next_pid = 0
        self._clock = 0
        # pages staged ahead of a dispatch and not yet consumed: a gather
        # finding one resident on a PU arena is a prefetch hit
        self._prefetched: Set[int] = set()
        # (prefill stage, decode stage) pairs already warned about an
        # unprofiled KV shape — warn once, then silently fall back
        self._warned_stages: Set[Tuple[str, str]] = set()
        # run totals (BackendRun accounting)
        self.migrations = 0
        self.bytes_moved = 0.0
        self.hits = 0
        self.hit_tokens = 0
        self.hit_declined = 0
        self.evictions = 0
        self.evicted_bytes = 0.0
        self.fetches = 0
        self.fetched_bytes = 0.0
        self.prefetches = 0
        self.prefetch_bytes = 0.0
        self.prefetch_hits = 0
        self.soft_overflows = 0
        # drainable queues, consumed by whichever backend dispatches next:
        # (event_name, node) pairs, (stage, src_tier, dst_tier, tokens)
        # spill transfers (the simulator charges them ground-truth seconds;
        # the live runtime records them), and (stage, src, dst, tokens,
        # credit_s) prefetches — the credit is the compute-overlap window
        # the scheduler issued the staging under, so the simulator charges
        # only the residual beyond it
        self._events: List[Tuple[str, Node]] = []
        self._transfers: List[Tuple[str, str, str, int]] = []
        self._prefetch_q: List[Tuple[str, str, str, int, float]] = []

    # -- page primitives -----------------------------------------------------
    def _touch(self, pg: KVPage) -> None:
        self._clock += 1
        pg.last_use = self._clock

    def _page_bytes(self, pg: KVPage) -> float:
        return pg.tokens * self.perf.kv_bytes.get(pg.stage, 0.0)

    def _place(self, pg: KVPage, tier: str) -> None:
        by = self._page_bytes(pg)
        old = pg.tier
        self._tier_pages.setdefault(old, set()).discard(pg.pid)
        self._tier_used[old] = self._tier_used.get(old, 0.0) - by
        pg.tier = tier
        self._tier_pages.setdefault(tier, set()).add(pg.pid)
        self._tier_used[tier] = self._tier_used.get(tier, 0.0) + by

    def _alloc(self, stage: str, tokens: int, tier: str,
               content: Optional[str], node: Node) -> KVPage:
        by = tokens * self.perf.kv_bytes.get(stage, 0.0)
        self._make_room(tier, by, node)
        pg = KVPage(pid=self._next_pid, stage=stage, tokens=int(tokens),
                    tier=tier, hash=content)
        self._next_pid += 1
        self._pages[pg.pid] = pg
        self._tier_pages.setdefault(tier, set()).add(pg.pid)
        self._tier_used[tier] = self._tier_used.get(tier, 0.0) + by
        if content is not None:
            self._index[content] = pg.pid
        self._touch(pg)
        return pg

    def _free(self, pg: KVPage) -> None:
        self._tier_pages.setdefault(pg.tier, set()).discard(pg.pid)
        self._tier_used[pg.tier] = (self._tier_used.get(pg.tier, 0.0)
                                    - self._page_bytes(pg))
        if pg.hash is not None and self._index.get(pg.hash) == pg.pid:
            del self._index[pg.hash]
        self._prefetched.discard(pg.pid)
        del self._pages[pg.pid]

    def _grow_page(self, pg: KVPage, tokens: int) -> None:
        by = tokens * self.perf.kv_bytes.get(pg.stage, 0.0)
        pg.tokens += int(tokens)
        self._tier_used[pg.tier] = self._tier_used.get(pg.tier, 0.0) + by
        self._touch(pg)

    def _capacity(self, tier: str) -> float:
        return self.perf.kv_capacity(tier)

    def _spill_target(self, tier: str) -> Optional[str]:
        if tier == DISK:
            return None
        return DISK if tier == DRAM else DRAM

    def _make_room(self, tier: str, need: float, node: Node) -> None:
        """Demote unpinned pages out of ``tier`` until ``need`` bytes fit
        (plain LRU; hit-frequency-weighted under ``prefetch`` — cold
        private pages go before shared prefix pages that keep earning
        hits).  Pinned pages (``refs > 0``) are never moved — when only
        pinned pages remain the arena soft-overflows instead (live
        streams beat the capacity model), and the breach is counted and
        emitted as a ``kv_soft_overflow`` event rather than passing
        silently; ``release`` demotes the excess once the pins drop."""
        cap = self._capacity(tier)
        if cap == float("inf"):
            return
        dst = self._spill_target(tier)
        while self._tier_used.get(tier, 0.0) + need > cap:
            victims = [self._pages[pid]
                       for pid in self._tier_pages.get(tier, ())
                       if self._pages[pid].refs <= 0]
            if not victims:
                self.soft_overflows += 1      # all pinned: soft overflow
                self._events.append((EV_KV_SOFT_OVERFLOW, node))
                return
            # draft pages always go first (the key's leading bool): with
            # no draft pages present the ordering is exactly the
            # pre-spec LRU, bit-identical with the mode off
            if self.prefetch_on:
                pg = min(victims, key=lambda p: (not p.draft, p.hits,
                                                 p.last_use, p.pid))
            else:
                pg = min(victims, key=lambda p: (not p.draft,
                                                 p.last_use, p.pid))
            if dst is None:
                self._free(pg)                # nowhere lower: drop
            else:
                self._make_room(dst, self._page_bytes(pg), node)
                self._transfers.append((pg.stage, tier, dst, pg.tokens))
                self._place(pg, dst)
            self.evictions += 1
            self.evicted_bytes += self._page_bytes(pg)
            self._events.append((EV_KV_EVICT, node))

    # -- stream bookkeeping --------------------------------------------------
    def _ensure(self, m: Node) -> PagedStream:
        key = stream_key(m)
        st = self._streams.get(key)
        if st is None:
            st = self._streams[key] = PagedStream(
                stage=decode_stage_for(m), pu=None, ctx_tokens=0)
        # reconcile against the node's own accounting: context the stream
        # should hold (prefill ctx + decoded so far) beyond what pages /
        # pending already cover becomes pending growth — this covers
        # un-stamped prefills and fine-grained chains whose decode kv_ctx
        # exceeds the sum of linked prefill pieces
        want = (int(m.payload.get("kv_ctx", 0))
                + int(m.payload.get("decode_served", 0)))
        if want > st.ctx_tokens:
            st.pending += want - st.ctx_tokens
            st.ctx_tokens = want
        return st

    def _materialize(self, st: PagedStream, node: Node) -> None:
        """Back ``st.pending`` tokens with private pages on the anchor PU
        (free: this is cache the stream produced in place)."""
        if st.pu is None or st.pending <= 0:
            return
        self._grow_tail(st, st.pending, st.pu, node)
        st.pending = 0

    def _grow_tail(self, st: PagedStream, tokens: int, tier: str,
                   node: Node) -> None:
        """Append ``tokens`` to the stream: fill the private tail page,
        then allocate fresh private pages on ``tier``."""
        left = int(tokens)
        if st.pages:
            tail = self._pages[st.pages[-1]]
            if (tail.hash is None and tail.tier == tier
                    and tail.tokens < self.page_tokens):
                take = min(self.page_tokens - tail.tokens, left)
                self._make_room(tier, take * self.perf.kv_bytes.get(
                    tail.stage, 0.0), node)
                self._grow_page(tail, take)
                left -= take
        while left > 0:
            take = min(self.page_tokens, left)
            pg = self._alloc(st.stage, take, tier, None, node)
            pg.refs = 1
            st.pages.append(pg.pid)
            left -= take

    # -- KVResidency protocol ------------------------------------------------
    def footprint_bytes(self, m: Node) -> float:
        """Resident KV bytes of stream ``m`` (ctx × profiled bytes/token —
        the same unit the monolith reports)."""
        st = self._ensure(m)
        return st.ctx_tokens * self.perf.kv_bytes.get(st.stage, 0.0)

    def resident_bytes(self, tier: Optional[str] = None) -> float:
        """Total page bytes, optionally restricted to one tier (PU name,
        "dram" or "disk"); stream-pending (not yet materialized) bytes
        count toward the no-tier total."""
        if tier is not None:
            return max(self._tier_used.get(tier, 0.0), 0.0)
        total = sum(self._page_bytes(pg) for pg in self._pages.values())
        total += sum(st.pending * self.perf.kv_bytes.get(st.stage, 0.0)
                     for st in self._streams.values())
        return total

    def tracked(self, m: Node) -> Optional[PagedStream]:
        return self._streams.get(stream_key(m))

    def resident_pu(self, m: Node) -> Optional[str]:
        """The PU holding most of ``m``'s stream's page bytes — the
        anchor preempted-member re-placement prefers.  Spill tiers
        ("dram"/"disk") are not placement anchors and are excluded;
        with no PU-resident pages the stream's nominal PU stands in.
        Deterministic tie-break by PU name, as in ``prefer_pu``."""
        st = self._streams.get(stream_key(m))
        if st is None:
            return None
        totals: Dict[str, float] = {}
        for pid in st.pages:
            pg = self._pages[pid]
            if pg.tier not in (DRAM, DISK):
                totals[pg.tier] = (totals.get(pg.tier, 0.0)
                                   + self._page_bytes(pg))
        if totals:
            return max(sorted(totals), key=lambda p: totals[p])
        return st.pu

    def prefer_pu(self, members: Sequence[Node]) -> Optional[str]:
        """Same anchor-resolution contract as the monolith: the PU holding
        the largest resident footprint, deterministic tie-breaks."""
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

    def _move_groups(self, st: PagedStream, m: Node, dst_pu: str
                     ) -> Dict[str, int]:
        """Tokens of ``st``'s pages NOT resident on ``dst_pu``, grouped by
        the tier they currently live on (pending tokens count at the
        anchor PU — they exist, just unmaterialized)."""
        groups: Dict[str, int] = {}
        for pid in st.pages:
            pg = self._pages[pid]
            if pg.tier != dst_pu:
                groups[pg.tier] = groups.get(pg.tier, 0) + pg.tokens
        if st.pending > 0 and st.pu is not None and st.pu != dst_pu:
            groups[st.pu] = groups.get(st.pu, 0) + st.pending
        return groups

    def migrate_penalty(self, node: Node, dst_pu: str,
                        B: float = 0.0) -> Optional[Tuple[int, float]]:
        """``(n_streams_moving, modeled_seconds)`` for serving ``node`` on
        ``dst_pu`` — page-granular: only non-resident pages pay, PU hops
        through the migration lines and spill-tier fetches through the
        fitted tier lines, φ-scaled.  ``None`` when the profile predates
        the migration grid (callers keep the legacy constant)."""
        moving, cost = 0, 0.0
        for m in _kv_members(node):
            st = self._streams.get(stream_key(m))
            if st is None:
                src = m.payload.get("batch_pu")
                if src is None or src == dst_pu:
                    continue
                ctx = self._ensure(m).ctx_tokens
                c = self.perf.migrate_cost(m.stage, src, dst_pu, ctx)
                if c is None:
                    return None
                moving += 1
                cost += c
                continue
            groups = self._move_groups(st, m, dst_pu)
            if not groups:
                continue
            any_move = False
            for tier, toks in sorted(groups.items()):
                if tier in (DRAM, DISK):
                    c = self.perf.fetch_cost(st.stage, tier, dst_pu, toks)
                else:
                    c = self.perf.migrate_cost(st.stage, tier, dst_pu, toks)
                if c is None:
                    return None
                cost += c
                any_move = True
            moving += 1 if any_move else 0
        if moving:
            cost *= self.perf.phi(node.stage, B)
        return moving, cost

    # -- backend hooks -------------------------------------------------------
    def migrate_for_dispatch(self, node: Node, pu: str
                             ) -> List[Tuple[Node, str, int, float]]:
        """Register decode work starting on ``pu`` and gather every member
        page onto it.  Returns ``(member, src_tier, tokens, bytes)`` per
        source tier actually moved — PU sources are migrations (counted
        in ``kv_migrations``/``kv_bytes_moved``, like the monolith),
        "dram"/"disk" sources are fetches.  Streams never served adopt
        ``pu`` free (legacy first-serve semantics); solo dispatches grow
        their stream by the served group, idempotently per piece."""
        moved: List[Tuple[Node, str, int, float]] = []
        is_round = bool(node.payload.get("decode_round"))
        for m in _kv_members(node):
            st = self._ensure(m)
            first_serve = st.pu is None
            if first_serve:
                st.pu = m.payload.get("batch_pu") or pu
            self._materialize(st, m)
            # gather non-resident pages page-granularly
            gather: Dict[str, Tuple[int, List[int]]] = {}
            for pid in st.pages:
                pg = self._pages[pid]
                if pid in self._prefetched:
                    # staged ahead of this dispatch: resident here = a
                    # prefetch hit; elsewhere = thrash, and the page
                    # falls through to the on-path gather below
                    self._prefetched.discard(pid)
                    if pg.tier == pu:
                        self.prefetch_hits += 1
                        m.payload["kv_prefetch_hits"] = (
                            m.payload.get("kv_prefetch_hits", 0) + 1)
                if pg.tier != pu:
                    toks, pids = gather.get(pg.tier, (0, []))
                    gather[pg.tier] = (toks + pg.tokens, pids + [pid])
            stream_moved = False
            for tier in sorted(gather):
                toks, pids = gather[tier]
                by = toks * self.perf.kv_bytes.get(st.stage, 0.0)
                self._make_room(pu, by, m)
                for pid in pids:
                    self._place(self._pages[pid], pu)
                    self._touch(self._pages[pid])
                moved.append((m, tier, toks, by))
                if tier in (DRAM, DISK):
                    # tier fetches are attributed like migrations: on the
                    # tracker for run totals AND on the member payload for
                    # per-query results — the orphaned-counter violation
                    # repro_torch.analysis.lint rule CNT001 exists to catch
                    self.fetches += 1
                    self.fetched_bytes += by
                    m.payload["kv_fetches"] = (
                        m.payload.get("kv_fetches", 0) + 1)
                    m.payload["kv_fetched_bytes"] = (
                        m.payload.get("kv_fetched_bytes", 0.0) + by)
                else:
                    stream_moved = True
                    self.bytes_moved += by
                    m.payload["kv_bytes_moved"] = (
                        m.payload.get("kv_bytes_moved", 0.0) + by)
            if stream_moved:
                self.migrations += 1
                m.payload["kv_migrations"] = (
                    m.payload.get("kv_migrations", 0) + 1)
            st.pu = pu
            if not is_round and m.id not in st.charged:
                st.charged.add(m.id)
                served = max(int(m.workload), 0)
                st.ctx_tokens += served
                self._grow_tail(st, served, pu, m)
        return moved

    def on_boundary(self, m: Node, pu: str, served: int,
                    left: bool = False) -> None:
        """One decode-round boundary: the member's cache grew by ``served``
        tokens on ``pu``; a leaver frees its footprint."""
        if left:
            self.release(m)
            return
        st = self._ensure(m)
        st.pu = pu
        self._materialize(st, m)
        served = max(int(served), 0)
        st.ctx_tokens += served
        self._grow_tail(st, served, pu, m)

    def release(self, m: Node) -> None:
        """Terminal release of ``m``'s stream: private pages free, hashed
        (prefix-cache) pages stay resident at ``refs == 0`` — evictable,
        reusable by the next query with the same prefix.  Tiers that an
        earlier all-pinned soft overflow left above capacity demote
        their (now unpinned) excess here — the conservation guarantee
        that every tier returns under capacity once streams release.
        The stream's speculative draft mirror (``<stream>#draft``), when
        one exists, releases with it — its private draft pages free
        outright."""
        for key in (stream_key(m), stream_key(m) + DRAFT_KEY):
            st = self._streams.pop(key, None)
            if st is None:
                continue
            touched: Set[str] = set()
            for pid in st.pages:
                pg = self._pages.get(pid)
                if pg is None:
                    continue
                pg.refs = max(pg.refs - 1, 0)
                if pg.refs == 0 and pg.hash is None:
                    self._free(pg)
                elif pg.refs == 0:
                    touched.add(pg.tier)
            for tier in sorted(touched):
                if (self._tier_used.get(tier, 0.0) > self._capacity(tier)
                        and any(self._pages[pid].refs <= 0
                                for pid in self._tier_pages.get(tier, ()))):
                    self._make_room(tier, 0.0, m)

    # -- runtime invariants (REPRO_CHECK=1) ----------------------------------
    def check_quiescent(self) -> None:
        """Assert the paged store's end-of-run conservation guarantees.
        Unlike the monolithic tracker, resident bytes do NOT return to
        zero — hashed prefix pages stay resident at ``refs == 0`` by
        design, reusable by the next query — so quiescence here means:
        no stream is still tracked, no page is still pinned, every
        tier's byte accounting matches its page table, and no tier is
        left over capacity (the soft-overflow demote-on-release
        guarantee).  Called by both backends at end of run when
        ``REPRO_CHECK=1`` (see ``core/checks.py``)."""
        from repro_torch.core.checks import invariant
        invariant(not self._streams,
                  "PagedKVCache quiescence: streams still tracked at end "
                  f"of run: {sorted(self._streams)[:6]}")
        pinned = [pg.pid for pg in self._pages.values() if pg.refs > 0]
        invariant(not pinned,
                  "PagedKVCache quiescence: pages still pinned at end of "
                  f"run: {pinned[:8]}")
        tiers = set(self._tier_pages) | set(self._tier_used)
        for tier in sorted(tiers):
            want = sum(self._page_bytes(self._pages[pid])
                       for pid in self._tier_pages.get(tier, ()))
            got = self._tier_used.get(tier, 0.0)
            invariant(abs(got - want) <= 1e-6 * max(want, 1.0),
                      f"PagedKVCache tier {tier!r}: _tier_used={got} "
                      f"disagrees with page table total {want}")
            invariant(got <= self._capacity(tier)
                      + 1e-6 * max(self._capacity(tier), 1.0)
                      or not self._tier_pages.get(tier),
                      f"PagedKVCache tier {tier!r}: {got} bytes resident "
                      f"above capacity {self._capacity(tier)} after all "
                      "streams released")

    def spec_draft_sync(self, m: Node, draft_stage: Optional[str],
                        pu: str) -> None:
        """Speculative-decoding boundary hook: mirror member ``m``'s
        draft-model cache — a second, smaller per-stream footprint keyed
        ``<stream>#draft`` whose pages are flagged ``draft`` and never
        pinned (``refs`` stays 0), making them the first eviction
        victims in any arena: draft cache can never push a verify page
        out.  The mirror grows to the verify stream's served context or
        trims the rejected speculative tail back down to it — never
        below, so rollback cannot move a served boundary backwards."""
        if not draft_stage or draft_stage not in self.perf.kv_bytes:
            return
        vst = self._streams.get(stream_key(m))
        target = vst.ctx_tokens if vst is not None else 0
        key = stream_key(m) + DRAFT_KEY
        st = self._streams.get(key)
        if st is None:
            if target <= 0:
                return
            st = self._streams[key] = PagedStream(stage=draft_stage,
                                                  pu=pu, ctx_tokens=0)
        st.pu = pu
        if target > st.ctx_tokens:
            left = target - st.ctx_tokens
            if st.pages:
                tail = self._pages.get(st.pages[-1])
                if (tail is not None and tail.tier == pu
                        and tail.tokens < self.page_tokens):
                    take = min(self.page_tokens - tail.tokens, left)
                    self._make_room(pu, take * self.perf.kv_bytes.get(
                        tail.stage, 0.0), m)
                    self._grow_page(tail, take)
                    left -= take
            while left > 0:
                take = min(self.page_tokens, left)
                pg = self._alloc(st.stage, take, pu, None, m)
                pg.draft = True
                st.pages.append(pg.pid)
                left -= take
        elif target < st.ctx_tokens:
            need = st.ctx_tokens - target
            while need > 0 and st.pages:
                pg = self._pages.get(st.pages[-1])
                if pg is None:
                    st.pages.pop()
                    continue
                if pg.tokens <= need:
                    st.pages.pop()
                    need -= pg.tokens
                    self._free(pg)
                else:
                    by = need * self.perf.kv_bytes.get(pg.stage, 0.0)
                    pg.tokens -= need
                    self._tier_used[pg.tier] = (
                        self._tier_used.get(pg.tier, 0.0) - by)
                    need = 0
        st.ctx_tokens = target

    # -- prefix cache --------------------------------------------------------
    def apply_prefix_hits(self, n: Node) -> None:
        """Scheduler first-seen hook for a ``stream_prefill`` node: trim
        the node's workload by the longest resident page-aligned prefix
        *worth taking* — the hit-or-recompute rule: a resident run only
        trims workload up to the length where the modeled spill-fetch
        cost still undercuts the prefill compute it skips (a
        disk-resident "hit" can lose; the losing tail is declined and
        counted in ``kv_hit_declined``).  Hits keep ≥ 1 token so the
        node still anchors its successors, and hit pages are referenced
        immediately (pinned) so they cannot evict before
        ``on_prefill_done`` adopts them for the stream."""
        segs = n.payload.get("prefix_segments")
        if not segs or n.payload.get("kv_prefix_done"):
            return
        n.payload["kv_prefix_done"] = True
        stage = decode_stage_for(n)
        if stage not in self.perf.kv_bytes:
            key = (n.stage, stage)
            if key not in self._warned_stages:
                self._warned_stages.add(key)
                warnings.warn(
                    f"stage {n.stage!r} resolves to decode stage "
                    f"{stage!r}, which has no profiled KV shape — set "
                    "StageSpec.kv_stage to page its cache under the "
                    "right profile (prefix reuse disabled for it)",
                    RuntimeWarning, stacklevel=2)
            return
        hits: List[int] = []
        for h, _tok in page_keys(segs, self.page_tokens):
            pid = self._index.get(h)
            if pid is None:
                break
            hits.append(pid)
        if not hits:
            return
        keep, toks = self._hit_or_recompute(n, stage, hits)
        if keep < len(hits):
            declined = len(hits) - keep
            self.hit_declined += declined
            n.payload["kv_hit_declined"] = (
                n.payload.get("kv_hit_declined", 0) + declined)
            self._events.append((EV_KV_HIT_DECLINED, n))
            hits = hits[:keep]
        if not hits:
            return
        trim = min(toks, max(int(n.workload) - 1, 0))
        if trim <= 0:
            return
        n.workload = int(n.workload) - trim
        for pid in hits:
            pg = self._pages[pid]
            pg.refs += 1
            pg.hits += 1
            self._touch(pg)
        n.payload["kv_page_hits"] = len(hits)
        n.payload["kv_hit_tokens"] = trim
        n.payload["kv_hit_pages"] = tuple(hits)
        self.hits += len(hits)
        self.hit_tokens += trim
        self._events.append((EV_KV_PAGE_HIT, n))

    def _min_fetch(self, stage: str, src: str, tokens: int
                   ) -> Optional[float]:
        """Cheapest fitted fetch line out of spill tier ``src`` for
        ``tokens`` of ``stage``'s pages (``None`` when no line fits —
        callers fall back to the legacy always-hit behaviour)."""
        best: Optional[float] = None
        for (s, a, b) in sorted(self.perf.fetch_coef):
            if s != stage or a != src:
                continue
            c = self.perf.fetch_cost(stage, src, b, tokens)
            if c is not None and (best is None or c < best):
                best = c
        return best

    def _hit_or_recompute(self, n: Node, stage: str,
                          hits: Sequence[int]) -> Tuple[int, int]:
        """Hit-or-recompute: the longest resident prefix is only worth
        taking up to the page count maximizing (modeled prefill compute
        skipped) − (modeled spill-fetch cost paid).  PU-resident pages
        are free to hit; a run reaching into disk can cost more to
        fetch than to re-prefill.  Returns ``(pages_kept,
        tokens_kept)``; any unprofiled piece (no prefill grid for the
        stage, no fetch line for a spill tier) keeps the legacy
        always-hit behaviour so handcrafted profiles stay exact."""
        total_tok = sum(self._pages[pid].tokens for pid in hits)
        cum_tok = 0
        spill: Dict[str, int] = {}
        best_k, best_tok, best_net = 0, 0, 0.0
        for k, pid in enumerate(hits, start=1):
            pg = self._pages[pid]
            cum_tok += pg.tokens
            if pg.tier in (DRAM, DISK):
                spill[pg.tier] = spill.get(pg.tier, 0) + pg.tokens
            saved = self.perf.prefill_cost(n.stage, cum_tok)
            if saved is None:
                return len(hits), total_tok
            fetch = 0.0
            for src in sorted(spill):
                c = self._min_fetch(stage, src, spill[src])
                if c is None:
                    return len(hits), total_tok
                fetch += c
            net = saved - fetch
            if net > best_net:
                best_k, best_tok, best_net = k, cum_tok, net
        return best_k, best_tok

    def on_prefill_done(self, n: Node, pu: Optional[str]) -> None:
        """DAG completion hook for a ``stream_prefill`` node: materialize
        its prefix pages on ``pu`` (reusing resident hashed pages — the
        hit — and allocating the misses), then link them to the decode
        stream stamped as ``payload["kv_stream"]``."""
        if n.payload.get("kv_paged_done"):
            return
        n.payload["kv_paged_done"] = True
        segs = n.payload.get("prefix_segments")
        stage = decode_stage_for(n)
        if not segs or stage not in self.perf.kv_bytes or pu is None:
            return
        pages: List[int] = []
        total = 0
        for h, tok in page_keys(segs, self.page_tokens):
            pid = self._index.get(h)
            if pid is not None:
                pg = self._pages[pid]
                pg.refs += 1
                pg.hits += 1
                self._touch(pg)
            else:
                pg = self._alloc(stage, tok, pu, h, n)
                pg.refs = 1
            pages.append(pg.pid)
            total += tok
        # drop the apply_prefix_hits holds (stream refs now pin the hits)
        for pid in n.payload.pop("kv_hit_pages", ()):
            pg = self._pages.get(pid)
            if pg is not None:
                pg.refs = max(pg.refs - 1, 0)
        skey = n.payload.get("kv_stream")
        if skey is None:
            for pid in pages:                # no linked stream: cache only
                self._pages[pid].refs = max(self._pages[pid].refs - 1, 0)
            return
        st = self._streams.get(skey)
        if st is None:
            st = self._streams[skey] = PagedStream(stage=stage, pu=pu,
                                                   ctx_tokens=0)
        st.pages.extend(pages)
        st.ctx_tokens += total
        if st.pu is None:
            st.pu = pu

    # -- predictive prefetch ---------------------------------------------------
    def _headroom(self, tier: str) -> float:
        """Bytes ``tier`` can absorb without touching a pinned page or a
        page staged this pass: free capacity plus evictable (unpinned,
        un-prefetched) page bytes.  Speculative staging must fit inside
        this — prefetch never forces a soft overflow and never thrashes
        its own stagings."""
        cap = self._capacity(tier)
        if cap == float("inf"):
            return float("inf")
        free = cap - self._tier_used.get(tier, 0.0)
        evictable = sum(self._page_bytes(self._pages[pid])
                        for pid in self._tier_pages.get(tier, ())
                        if self._pages[pid].refs <= 0
                        and pid not in self._prefetched)
        return free + evictable

    def prefetch(self, node: Node, dst_pu: str, budget_s: float,
                 pids: Optional[Sequence[int]] = None) -> float:
        """Pre-stage ``node``'s spill-resident (dram/disk) pages onto
        ``dst_pu`` under a compute-overlap window of ``budget_s``
        modeled seconds; returns the modeled transfer seconds consumed
        (the scheduler debits its window — the transfer queue is
        serial, so groups split one budget sequentially).  ``pids``
        restricts the page set (e.g. a prefill's ``kv_hit_pages``);
        default is the node's tracked stream.  PU-resident pages never
        move (that is the dispatch gather's migration to price), and a
        group is clipped — not forced — to the destination's evictable
        headroom (staging what fits, leaving the tail for the on-path
        gather) and skipped when it has no fitted fetch line.
        Each staged group queues ``(stage, src, dst, tokens, credit)``
        for the backends: the simulator charges only the ground-truth
        residual beyond the credit; the live runtime records it."""
        if not self.prefetch_on or budget_s <= 0.0:
            return 0.0
        if pids is None:
            st = self.tracked(node)
            pids = tuple(st.pages) if st is not None else ()
        groups: Dict[Tuple[str, str], Tuple[int, List[int]]] = {}
        for pid in pids:
            pg = self._pages.get(pid)
            if (pg is None or pg.tier not in (DRAM, DISK)
                    or pid in self._prefetched):
                continue
            toks, lst = groups.get((pg.tier, pg.stage), (0, []))
            groups[(pg.tier, pg.stage)] = (toks + pg.tokens, lst + [pid])
        spent = 0.0
        for (tier, stage) in sorted(groups):
            if budget_s - spent <= 0.0:
                break
            _toks, lst = groups[(tier, stage)]
            head = self._headroom(dst_pu)
            take: List[int] = []
            take_toks, by = 0, 0.0
            for pid in lst:
                pby = self._page_bytes(self._pages[pid])
                if by + pby > head:
                    break
                take.append(pid)
                take_toks += self._pages[pid].tokens
                by += pby
            if not take:
                continue
            cost = self.perf.fetch_cost(stage, tier, dst_pu, take_toks)
            if cost is None:
                continue
            credit = min(cost, budget_s - spent)
            self._make_room(dst_pu, by, node)
            for pid in take:
                self._place(self._pages[pid], dst_pu)
                self._touch(self._pages[pid])
                self._prefetched.add(pid)
            self.prefetches += 1
            self.prefetch_bytes += by
            node.payload["kv_prefetches"] = (
                node.payload.get("kv_prefetches", 0) + 1)
            node.payload["kv_prefetch_bytes"] = (
                node.payload.get("kv_prefetch_bytes", 0.0) + by)
            self._events.append((EV_KV_PREFETCH, node))
            self._prefetch_q.append(
                (stage, tier, dst_pu, take_toks, credit))
            spent += credit
        return spent

    # -- drain queues (backend accounting) -----------------------------------
    def drain_events(self) -> List[Tuple[str, Node]]:
        ev, self._events = self._events, []
        return ev

    def drain_transfers(self) -> List[Tuple[str, str, str, int]]:
        t, self._transfers = self._transfers, []
        return t

    def drain_prefetches(self) -> List[Tuple[str, str, str, int, float]]:
        q, self._prefetch_q = self._prefetch_q, []
        return q
