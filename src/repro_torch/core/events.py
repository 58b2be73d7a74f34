"""Central registry of timeline-event names.

Both execution substrates (``core/simulator.py`` and
``serving/executor.py``) record the run as ``(t, event, node_id)``
triples, and a long tail of consumers — ``BackendRun`` counter
derivation, per-query attribution in ``api/results.py``, the session's
streaming observer, benchmark metrics — dispatch on the *string value*
of ``event``.  A typo'd emit therefore fails silently: the event lands
on the timeline, every ``e[1] == "..."`` filter misses it, and a
counter quietly under-reports (exactly the bug class the soft-overflow
accounting leak in PR 7 was).

This module is the single source of truth.  Emit sites and comparison
sites use the ``EV_*`` constants; ``repro_torch.analysis.lint`` rejects raw
event-string literals in the event-handling modules, and
``repro_torch.analysis.tracecheck`` rejects recorded events whose name is not
in :data:`ALL_EVENTS`.

The constant *values* are the historical strings, so recorded
timelines, goldens, and bench baselines are bit-identical across the
migration.
"""
from __future__ import annotations

# -- node lifecycle ----------------------------------------------------------
EV_START = "start"            # dispatch began on a PU
EV_DONE = "done"              # node (or fused dispatch) completed
EV_TOKENS = "tokens"          # resident decode-round member advanced one
#                               token group at a boundary without finishing
EV_CANCELLED = "cancelled"    # user-requested cancel finalized the node

# -- re-serve (the first attempt did not complete) ---------------------------
EV_REDISPATCH = "redispatch"  # simulator: speculative straggler re-dispatch
EV_STRAGGLER = "straggler"    # live runtime: heartbeat-detected straggler
EV_RETRY = "retry"            # live runtime: stage fn raised; retrying
EV_PREEMPT = "preempt"        # member released from a preempted fused
#                               dispatch at a boundary split (returns READY)

# -- KV-cache subsystem ------------------------------------------------------
EV_KV_MIGRATE = "kv_migrate"            # resident cache moved PU -> PU
EV_KV_FETCH = "kv_fetch"                # cache gathered from a spill tier
EV_KV_PAGE_HIT = "kv_page_hit"          # prefix-cache hit on a prefill
EV_KV_HIT_DECLINED = "kv_hit_declined"  # hit-or-recompute rule declined
EV_KV_EVICT = "kv_evict"                # page demoted/dropped for room
EV_KV_PREFETCH = "kv_prefetch"          # pages staged ahead of a dispatch
EV_KV_SOFT_OVERFLOW = "kv_soft_overflow"  # all-pinned capacity breach

ALL_EVENTS = frozenset({
    EV_START, EV_DONE, EV_TOKENS, EV_CANCELLED,
    EV_REDISPATCH, EV_STRAGGLER, EV_RETRY, EV_PREEMPT,
    EV_KV_MIGRATE, EV_KV_FETCH, EV_KV_PAGE_HIT, EV_KV_HIT_DECLINED,
    EV_KV_EVICT, EV_KV_PREFETCH, EV_KV_SOFT_OVERFLOW,
})

# the three "this dispatch did not complete; a re-serve follows" events —
# BackendRun.redispatches and QueryResult.redispatches count exactly these
REDISPATCH_EVENTS = (EV_REDISPATCH, EV_STRAGGLER, EV_RETRY)

# spill tiers of the paged KV store ("dram"/"disk", vs. PU-name tiers);
# a gather sourced from one of these is a fetch, not a migration
SPILL_TIERS = ("dram", "disk")
