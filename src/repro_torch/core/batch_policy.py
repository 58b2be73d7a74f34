"""Adaptive batching policy — coalesce/decode caps derived online (§4.2).

HeRo's thesis is that profiling-based performance models should *drive*
the scheduler: Eq. 3 derives the partition count n* online from the
fitted model instead of from constants.  This module applies the same
move to the batching layer, replacing the three hand-picked knobs
(``coalesce_cap``, ``coalesce_window``, ``decode_batch_cap``) with
derivations from :class:`LinearPerfModel`'s profiled grids:

- **decode width cap** — enumerate the profiled ``(width, group)`` decode
  grid the way Eq. 3 enumerates n* and keep widening the resident batch
  while the marginal per-member latency gain of one more resident exceeds
  the queueing delay of waiting for that member to arrive (an EWMA of
  ready-pool inter-arrivals tracked by the scheduler).  Under saturating
  arrivals the delay term vanishes and the cap sits at the argmin of the
  per-member curve; under sparse arrivals it backs off toward narrow
  batches — no single constant is right for both, which is exactly why
  the fixed ``decode_batch_cap`` had to go (Agent.xpu makes the same
  argument for heterogeneous-SoC agentic serving).

- **coalesce cap** — the dual for batchable stages: the knee of the
  profiled per-item latency curve p0(n)/n (Fig. 2's "larger batches do
  not always yield better per-item efficiency").

- **coalesce window** — from the fitted per-dispatch overhead versus the
  observed inter-arrival rate: a fused dispatch may occupy its PU for a
  few inter-arrival periods (absorbing work saves one invocation overhead
  per member), but never so long that latecomers starve behind it; as
  arrivals saturate (τ → 0) the queue is service-bound and the window
  opens to the profiled ladder top.

- **per-round token group** (the ROADMAP horizon policy) — each decode
  round sorts residents by remaining tokens and enumerates grid groups
  aligned to the *member remainder distribution* instead of padding
  ragged tails to a fixed group; the scheduler scores candidates by mean
  member completion (Σ⌈rᵢ/g⌉·p0 / w), so a short straggler's early leave
  is weighed against the per-round overhead of extra boundaries.

``FixedBatchPolicy`` preserves the PR 3 constants bit-exactly (pinned
against committed goldens); ``AdaptiveBatchPolicy`` is selected with
``SchedulerConfig.batch_policy = "adaptive"`` /
``HeroSession(batch_policy="adaptive")``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dag import Node
from repro_torch.core.partitioner import ceil_passes
from repro_torch.core.perf_model import LinearPerfModel


class ArrivalTracker:
    """Burst-aware EWMA of ready-pool inter-arrival times, per
    (stage, kind) key.

    The scheduler observes every node the moment it first enters the
    ready pool (decode residents re-entering at a token-group boundary
    count too: a rejoining stream IS the next member a forming batch
    would wait for).  ``tau`` is the policy's queueing-delay estimate for
    "one more member".

    *Fresh* arrivals landing at the same scheduling instant are a
    *burst* — a W2 rewriter releasing 4 sub-queries at once spawns 4
    streams whose first ready-pool entries share one timestamp.  A plain
    gap EWMA aliases such a burst as one arrival — one inter-arrival gap
    for b members — so the width-beyond-ready decision mis-estimates the
    per-member arrival rate by ~b×.  Two estimates are therefore kept:

    - :meth:`tau` — burst-corrected *per-member* inter-arrival:
      ``EWMA(gap) / EWMA(batch size)`` over fresh-burst-deduplicated
      arrival events.  What the decode width cap compares marginal
      per-member gains against — one arrival event repays the wait with
      the whole burst's worth of members.
    - :meth:`tau_event` — the PR 4 raw gap EWMA (every observation, zero
      gaps included).  What the coalesce *window* consumes: it bounds
      how long a fused dispatch may hold a PU before the next
      *newcomer* starves behind it, and a burst's latecomers starve
      together, not b× faster.

    Singleton arrivals make both estimates identical to the PR 4 one
    (batch EWMA pinned at 1).  Decode residents *re-entering* at a
    token-group boundary count as individual arrivals (``fresh=False``)
    exactly as before — a re-fusing batch's own boundary is not
    evidence about how fast new members show up.
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._last: Dict[Tuple[str, str], float] = {}
        # fresh members that arrived at _last's instant, not yet flushed
        # into the batch EWMA (a burst closes when a later observation
        # lands)
        self._pending: Dict[Tuple[str, str], int] = {}
        self._gap: Dict[Tuple[str, str], float] = {}
        self._batch: Dict[Tuple[str, str], float] = {}
        self._tau_event: Dict[Tuple[str, str], float] = {}

    def observe(self, key: Tuple[str, str], now: float,
                fresh: bool = True) -> None:
        last = self._last.get(key)
        if last is None:
            self._last[key] = now
            self._pending[key] = 1
            return
        a = self.alpha
        # event estimate: every observation, zero gaps included (the
        # PR 4 estimator, bit-for-bit)
        gap = max(now - last, 0.0)
        prev_e = self._tau_event.get(key)
        self._tau_event[key] = (gap if prev_e is None
                                else (1 - a) * prev_e + a * gap)
        if fresh and now <= last:
            # same scheduling instant, new stream: the burst grows; the
            # per-member estimate records no gap yet
            self._pending[key] = self._pending.get(key, 1) + 1
            self._last[key] = now
            return
        batch = float(self._pending.get(key, 1))
        prev_g = self._gap.get(key)
        self._gap[key] = gap if prev_g is None else (1 - a) * prev_g + a * gap
        prev_b = self._batch.get(key)
        self._batch[key] = (batch if prev_b is None
                            else (1 - a) * prev_b + a * batch)
        self._last[key] = now
        self._pending[key] = 1

    def tau(self, key: Tuple[str, str]) -> Optional[float]:
        """Burst-corrected EWMA mean *per-member* inter-arrival for
        ``key`` (None until 2 distinct arrival instants)."""
        gap = self._gap.get(key)
        if gap is None:
            return None
        return gap / max(self._batch.get(key, 1.0), 1.0)

    def tau_event(self, key: Tuple[str, str]) -> Optional[float]:
        """Raw per-observation gap EWMA (None until 2 observations) —
        the PR 4 estimator, kept for the coalesce-window fairness
        bound."""
        return self._tau_event.get(key)


class FixedBatchPolicy:
    """The PR 3 behavior: the three SchedulerConfig constants, the fixed
    token-group ladder, and horizon-amortized round scoring — bit-exact
    (pinned against ``tests/goldens/``)."""

    name = "fixed"

    def __init__(self, cfg, perf: LinearPerfModel, kv=None):
        self.cfg = cfg
        self.perf = perf
        # KV-residency tracker (core/kv_residency.py) when the scheduler
        # runs with it: lets the adaptive width cap price residency from
        # the batch's measured state instead of a fixed-width probe
        self.kv = kv

    # -- caps / windows ----------------------------------------------------
    def decode_width_cap(self, stage: str, prefer_pu: Optional[str],
                         tau: Optional[float],
                         remainders: Optional[Sequence[int]] = None) -> int:
        return self.cfg.decode_batch_cap

    def coalesce_cap(self, stage: str, pu: Optional[str] = None) -> int:
        return self.cfg.coalesce_cap

    def coalesce_window(self, stage: str, tau: Optional[float]) -> int:
        return self.cfg.coalesce_window

    # -- decode rounds -----------------------------------------------------
    def round_group_candidates(self, node: Node) -> Optional[Sequence[int]]:
        """None = the scheduler's fixed token-group ladder."""
        return None

    def round_passes(self, node: Node, batch: int) -> float:
        """Eq. 3 amortization over the batch's remaining horizon — the
        PR 3 scoring (the dispatch itself still serves one group)."""
        return ceil_passes(node.workload, batch)

    # -- speculative decoding ----------------------------------------------
    def spec_width_candidates(self, draft_stage: str, verify_stage: str,
                              draft_pu: str, verify_pu: str,
                              alpha: float) -> Sequence[int]:
        """Draft widths the scheduler's speculative plan enumerates for a
        (draft, verify) PU pair.  Fixed policy: the single configured
        width, snapped to the profiled grid (nearest below, else the
        grid floor) so the pair lookup is exact."""
        w = max(int(self.cfg.spec_draft_width), 1)
        grid = self.perf.spec_width_grid(draft_stage, verify_stage,
                                         draft_pu, verify_pu)
        if not grid:
            return (w,)
        below = [g for g in grid if g <= w]
        return (below[-1] if below else grid[0],)


class AdaptiveBatchPolicy(FixedBatchPolicy):
    """Caps/windows/groups derived online from the profiled grids."""

    name = "adaptive"

    def __init__(self, cfg, perf: LinearPerfModel, kv=None):
        super().__init__(cfg, perf, kv)
        self._pus: List[str] = sorted({pu for (_s, pu) in perf.coef})
        self._cap_cache: Dict[Tuple[str, str], int] = {}
        self._anchor_cache: Dict[str, Optional[str]] = {}
        # (stage, pu) -> (knee, gains, residency-per-round): the profiled
        # tables are static, so everything except the tau comparison is
        # derived once — decode_width_cap runs in the scheduler hot loop
        self._width_cache: Dict[Tuple[str, str], tuple] = {}
        # (pair, alpha-bucket) -> ranked draft widths (hot-loop cache)
        self._spec_cache: Dict[tuple, Sequence[int]] = {}

    # -- anchors -----------------------------------------------------------
    def _anchor_pu(self, stage: str, probe_batch: int = 16) -> Optional[str]:
        """The PU Eq. 3 will most likely map ``stage`` to: fastest
        profiled per-item latency at a mid-grid probe shape."""
        if stage in self._anchor_cache:
            return self._anchor_cache[stage]
        best, best_t = None, float("inf")
        for pu in self._pus:
            if not self.perf.supported(stage, pu):
                continue
            t = self.perf.per_item(stage, pu, probe_batch)
            if t < best_t:
                best, best_t = pu, t
        self._anchor_cache[stage] = best
        return best

    # -- decode width cap --------------------------------------------------
    def decode_width_cap(self, stage: str, prefer_pu: Optional[str],
                         tau: Optional[float],
                         remainders: Optional[Sequence[int]] = None) -> int:
        """Widen while the marginal per-member gain of one more resident
        beats the queueing delay of waiting for it.

        The gain of width w over the previous grid width repeats at every
        round the stream stays resident, so it is compared against the
        arrival gap amortized over those rounds (estimated from the
        candidates' own remaining tokens when known); ``tau=None`` (no
        arrival history yet) and saturating arrivals both degrade to the
        pure argmin-knee of the profiled per-member curve.
        """
        pu = prefer_pu if prefer_pu is not None else self._anchor_pu(stage)
        if pu is None:
            return self.cfg.decode_batch_cap
        group = self.cfg.token_group
        cached = self._width_cache.get((stage, pu))
        if cached is None:
            gains = self.perf.decode_marginal_gains(stage, pu, group)
            knee = 1
            for w, gain in gains:
                if gain <= 0:
                    break
                knee = w
            p_round = (self.perf.p0_decode(stage, pu, 2, group)
                       if gains else 0.0)
            groups = self.perf.decode_group_grid(stage, pu)
            mid = groups[len(groups) // 2] * 2 if groups else 4 * group
            cached = (knee, tuple(gains), p_round, mid)
            self._width_cache[(stage, pu)] = cached
        knee, gains, p_round, default_horizon = cached
        if not gains:
            return self.cfg.decode_batch_cap
        # Two different decisions hide in one cap.  (1) Truncation of the
        # ALREADY-READY candidate set: those members ride along for free
        # (they are queued either way), so cutting them can only be right
        # past the spill knee of the profiled per-member curve — the pure
        # Eq. 3 argmin over the width axis of the decode grid.
        # (2) Width reserved BEYOND the ready set: a member who has not
        # arrived yet joins a boundary for free only if the arrival gap
        # fits inside the stream's resident lifetime; past that, widening
        # implies a real wait of the excess gap, repaid once over every
        # resident round — so the marginal per-member gain must beat
        # (tau − residency)/rounds for the extra width to be worth
        # holding open.  Under saturating or bursty arrivals the wait
        # term vanishes and both parts agree on the knee.
        horizon = (sum(remainders) / len(remainders) if remainders
                   else default_horizon)
        rounds = max(float(ceil_passes(int(horizon), group)), 1.0)
        if self.kv is not None and remainders:
            # KV residency tracked: price the wait against the batch's
            # *measured* residency — a round at the candidates' actual
            # width, not the width-2 probe (the footprint the tracker
            # holds is exactly this width's worth of resident caches)
            p_round = self.perf.p0_decode(stage, pu,
                                          max(len(remainders), 2), group)
        threshold = 0.0
        if tau is not None:
            threshold = max(tau - rounds * p_round, 0.0) / rounds
        waitable = 1
        for w, gain in gains:
            if gain <= threshold:
                break
            waitable = w
        ready = len(remainders) if remainders else 0
        cap = max(waitable, min(ready, knee))
        return max(cap, 2)    # a batch needs two members to exist at all

    # -- coalesce cap (batchable stages) -----------------------------------
    def coalesce_cap(self, stage: str, pu: Optional[str] = None) -> int:
        """Knee of the profiled per-item curve — merged dispatches stay on
        measured sweet-spot shapes instead of running out to an arbitrary
        constant.  ``pu`` pins the curve when the mapper already knows the
        target; otherwise the stage's anchor (fastest) PU is used."""
        if pu is None or not self.perf.supported(stage, pu):
            pu = self._anchor_pu(stage)
        if pu is None:
            return self.cfg.coalesce_cap
        key = (stage, pu)
        if key in self._cap_cache:
            return self._cap_cache[key]
        cap, best = None, float("inf")
        for n, _gain in self.perf.batch_marginal_gains(stage, pu):
            t = self.perf.per_item(stage, pu, n)
            if t < best:
                cap, best = n, t
        cap = cap if cap is not None else self.cfg.coalesce_cap
        self._cap_cache[key] = cap
        return cap

    # -- coalesce window ---------------------------------------------------
    WINDOW_FAIRNESS = 4.0      # inter-arrival periods one dispatch may hold
    WINDOW_MAX_PASSES = 8      # τ → 0 ladder top (saturation)

    def coalesce_window(self, stage: str, tau: Optional[float]) -> int:
        """Total workload one fused dispatch may absorb, from the fitted
        per-dispatch overhead versus the observed inter-arrival rate.

        Absorbing a member saves one invocation overhead ``o`` but
        extends the dispatch's PU occupancy; the window therefore admits
        as many cap-sized passes as fit in ``WINDOW_FAIRNESS`` arrival
        periods — under sparse arrivals the fused dispatch must not hold
        the PU past the point where a newly-arrived query would starve
        behind it, while under saturation (τ → 0, or τ below the pass
        time + amortized overhead) the queue is service-bound and the
        window opens to the ladder top.
        """
        cap = self.coalesce_cap(stage)
        pu = self._anchor_pu(stage)
        if pu is None or tau is None:
            return cap * self.WINDOW_MAX_PASSES
        p_pass = self.perf.p0(stage, pu, cap)
        o = self.perf.dispatch_overhead(stage, pu)
        budget = self.WINDOW_FAIRNESS * (p_pass + o)
        passes = int(budget / max(tau, 1e-9))
        return cap * min(max(passes, 1), self.WINDOW_MAX_PASSES)

    # -- decode rounds: per-round group (horizon policy) -------------------
    def round_group_candidates(self, node: Node) -> Optional[Sequence[int]]:
        """Grid groups aligned to the sorted member remainders.

        Instead of padding ragged tails to a fixed ladder, the candidates
        are the profiled groups nearest the shortest member's remaining
        tokens, the median remainder, and the full horizon — the
        scheduler's Eq. 3 pass then scores them by mean member completion
        (see :meth:`round_passes`), trading a short straggler's early
        leave against the per-round overhead of extra boundaries.
        """
        rem = self._remainders(node)
        if rem is None:
            return None
        pu = (node.payload.get("prefer_pu")
              or self._anchor_pu(node.stage, self.cfg.token_group))
        grid = self.perf.decode_group_grid(node.stage, pu) if pu else ()
        if not grid:
            grid = (self.cfg.token_group, self.cfg.token_group * 2,
                    self.cfg.token_group * 4)
        anchors = (rem[0], rem[len(rem) // 2], rem[-1])
        cands = set()
        for r in anchors:
            below = [g for g in grid if g <= r]
            cands.add(below[-1] if below else grid[0])
        return sorted(min(g, max(node.workload, 1)) for g in cands)

    # completion quantile the "quantile" round scoring charges (p99-aware:
    # with ≤ 8 residents this is the slowest member, the tail the mixed
    # sparse-arrival regime loses on)
    ROUND_QUANTILE = 0.9

    def round_passes(self, node: Node, batch: int) -> float:
        """Member completion in rounds at group ``batch``.

        ``round_score="mean"`` (default): Σ⌈rᵢ/g⌉/w — the fixed policy
        charges the *longest* member's horizon to every candidate, which
        pads ragged tails; weighting by each resident's own remainder
        makes a group that releases short members at the next boundary
        score exactly as much better as the latency it reclaims.

        ``round_score="quantile"``: a high quantile
        (:data:`ROUND_QUANTILE`) of the member completions instead — the
        p99-aware variant: optimizing the mean trades the slowest
        member's finish for early leaves, exactly the mixed@2.0 p99 gap;
        scoring the tail keeps groups aligned to the members that define
        it."""
        rem = self._remainders(node)
        if rem is None:
            return ceil_passes(node.workload, batch)
        passes = sorted(ceil_passes(r, batch) for r in rem)
        if getattr(self.cfg, "round_score", "mean") == "quantile":
            k = min(int(self.ROUND_QUANTILE * len(passes)), len(passes) - 1)
            return float(passes[k])
        return sum(passes) / len(passes)

    # -- speculative decoding ----------------------------------------------
    # widths tried per (pair, alpha-bucket): the top of the accept-rate-
    # aware effective-throughput ranking over the profiled grid
    SPEC_TOP_WIDTHS = 2
    # alpha is bucketed for the cache key: the ranking is a step function
    # of alpha, so a coarse quantization keeps the hot loop table-driven
    SPEC_ALPHA_BUCKETS = 20

    def spec_width_candidates(self, draft_stage: str, verify_stage: str,
                              draft_pu: str, verify_pu: str,
                              alpha: float) -> Sequence[int]:
        """The (draft_width, verify_group) dual of the adaptive width
        cap: rank the profiled draft-width grid by accept-rate-aware
        effective throughput ``(1 + alpha·w) / cost(w)`` — cost pipelined
        (max) cross-PU, serialized (sum) on a shared PU — and enumerate
        the top few, letting Eq. 3's scoring pick between them per token
        group.  Falls back to the fixed policy's single width when the
        pair was never profiled."""
        a = max(min(float(alpha), 1.0), 0.0)
        bucket = int(a * self.SPEC_ALPHA_BUCKETS)
        key = (draft_stage, verify_stage, draft_pu, verify_pu, bucket)
        cached = self._spec_cache.get(key)
        if cached is not None:
            return cached
        grid = self.perf.spec_width_grid(draft_stage, verify_stage,
                                         draft_pu, verify_pu)
        if not grid:
            out = FixedBatchPolicy.spec_width_candidates(
                self, draft_stage, verify_stage, draft_pu, verify_pu, a)
            self._spec_cache[key] = out
            return out
        a_mid = (bucket + 0.5) / self.SPEC_ALPHA_BUCKETS
        ranked = sorted(
            grid, key=lambda w: -(self.perf.spec_throughput(
                draft_stage, verify_stage, draft_pu, verify_pu, w, a_mid)
                or 0.0))
        out = tuple(sorted(ranked[:self.SPEC_TOP_WIDTHS]))
        self._spec_cache[key] = out
        return out

    @staticmethod
    def _remainders(node: Node) -> Optional[List[int]]:
        """Sorted member remainders of a decode round: the ``remaining``
        snapshot ``fuse_decode`` records (refreshed by the scheduler when
        a cancelled round re-enters the pool), falling back to the live
        member workloads for rounds built outside the normal path."""
        rem = node.payload.get("remaining")
        if rem:
            return list(rem)
        members = node.payload.get("members")
        if not members:
            return None
        return sorted(m.workload for m in members)


def make_policy(cfg, perf: LinearPerfModel, kv=None):
    """Resolve ``SchedulerConfig.batch_policy`` to a policy object
    (``kv``: the scheduler's KV-residency tracker, when enabled)."""
    kinds = {"fixed": FixedBatchPolicy, "adaptive": AdaptiveBatchPolicy}
    name = getattr(cfg, "batch_policy", "fixed")
    if name not in kinds:
        raise KeyError(f"batch_policy {name!r}; pick from {sorted(kinds)}")
    score = getattr(cfg, "round_score", "mean")
    if score not in ("mean", "quantile"):
        raise KeyError(f"round_score {score!r}; pick from "
                       f"['mean', 'quantile']")
    return kinds[name](cfg, perf, kv)
