"""HeRo online heterogeneous scheduler — paper Alg. 1.

Node-centric dispatch: at every scheduling point (a completion event, or
new work arriving), the scheduler walks the ready set in criticality order
(Eq. 4), enumerates shape-aware configs per capable idle PU (Eq. 3), prunes
those violating the soft bandwidth budget, scores the rest with the
contention penalty (Eq. 5), and dispatches the argmin.  If the most
critical node has no feasible config it is deferred and the next one tried.

The techniques toggle independently (``SchedulerConfig``) which is
exactly what Table 3 ablates:
  - enable_partition    → Eq. 3 sub-stage partitioning
  - enable_criticality  → Eq. 4 priority (off = FIFO + earliest-finish)
  - enable_concurrency  → Eq. 5 penalty + B_soft gate (off = always admit)
  - coalesce            → cross-query batch coalescing (the dual of Eq. 3:
    READY batchable nodes of *different* queries sharing a (stage, kind)
    key merge into one fused dispatch — weight sweeps and per-invocation
    overheads are paid once for the whole group, the way Agent.xpu /
    RAGDoll batch concurrent requests on a shared accelerator)
``static_map`` pins stages to PUs (the llama.cpp-GPU / Powerserve-NPU /
Ayo-like baselines).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import concurrency as cc
from repro_torch.core import criticality as crit
from repro_torch.core.batch_policy import ArrivalTracker, make_policy
from repro_torch.core.dag import (READY, RUNNING, DynamicDAG, Node,
                            WorkflowTemplate, resolve_prefer_pu)
from repro_torch.core.kv_pages import PagedKVCache
from repro_torch.core.kv_residency import KVResidency, _kv_members
from repro_torch.core.partitioner import (ceil_passes, dispatch_passes,
                                    shape_aware_configs)
from repro_torch.core.perf_model import LinearPerfModel
from repro_torch.core.spec_decode import SpecTracker, draft_stage_of, spec_passes


# Boolean SchedulerConfig knobs that legitimately default ON: the paper's
# baseline HeRo strategy (partition + criticality + concurrency control)
# and continuous decode batching, which is a no-op until ``coalesce``
# gates it.  Every OTHER boolean knob is a feature gate and must default
# off so a default config stays bit-identical to the PR 2/3 goldens —
# repro_torch.analysis.lint rule CFG001 enforces exactly this list.
BASELINE_ON_KNOBS = frozenset({
    "enable_partition", "enable_criticality", "enable_concurrency",
    "decode_batch",
})


@dataclass
class SchedulerConfig:
    alpha: float = 0.35            # contention-penalty weight (grid-searched)
    beta: float = 0.6              # future-criticality weight (grid-searched)
    b_soft_frac: float = 0.90      # B_soft = frac · B0
    enable_partition: bool = True
    enable_criticality: bool = True
    enable_concurrency: bool = True
    static_map: Optional[Dict[str, str]] = None    # stage -> pu name
    token_group: int = 16
    # fault tolerance: re-dispatch a node when its runtime exceeds
    # straggler_factor × predicted latency (speculative execution)
    straggler_factor: float = 3.0
    # cross-query batch coalescing (multi-query serving; off for the
    # paper's single-query latency protocol)
    coalesce: bool = False
    # largest merged batch config enumerated — the top of the profiled
    # grid; within it Eq. 3 and the spill term pick the PU's sweet spot
    coalesce_cap: int = 256
    # max total workload absorbed into one fused dispatch: bounds how long
    # a single dispatch can occupy a PU (tail-latency fairness)
    coalesce_window: int = 512
    # continuous decode batching (vLLM/RAGDoll-style): stream_decode nodes
    # of different admitted queries share a resident per-(stage, PU) batch
    # at token-group granularity, with join/leave at group boundaries.
    # Effective only under ``coalesce`` (the multi-query serving mode).
    decode_batch: bool = True
    # max resident sequences per decode batch (profiled width grid top)
    decode_batch_cap: int = 8
    # seconds charged when a resident batch's next round moves PU (KV-cache
    # migration); keeps batches sticky per (stage, PU) unless moving wins.
    # The legacy constant — superseded by the modeled cost when
    # ``kv_residency`` is on, and the fallback when a loaded profile
    # predates the migration grid
    decode_migrate_cost: float = 0.01
    # per-stream KV-residency tracking (core/kv_residency.py): decode-round
    # PU moves are priced by the modeled migration cost (resident footprint
    # ÷ profiled PU-pair link bandwidth, φ-scaled) instead of the constant
    # above, and both backends register/charge the migrations
    # (kv_migrations / kv_bytes_moved in results).  Off = the legacy
    # constant and free migration physics, bit-identical to the
    # PR 2/3/4 goldens.
    kv_residency: bool = False
    # paged KV cache (core/kv_pages.py): supersedes the monolithic
    # kv_residency tracker with a page table — fixed-size pages in a
    # tiered store (PU arenas → DRAM pool → disk, LRU-with-pin eviction),
    # page-granular migration pricing, and a content-hash prefix cache
    # that lets prefill nodes skip resident shared-context pages
    # (cross-query reuse).  Implies residency tracking; off = bit-identical
    # to the PR 2/3/5 goldens (kv_residency decides the tracker as before)
    kv_pages: bool = False
    # tokens per KV page (page bytes = this × the stage's profiled GQA
    # cache bytes/token)
    kv_page_tokens: int = 64
    # predictive prefetch on the paged tiers (PerCache staging / RAGDoll
    # fetch-compute overlap): after each dispatch pass commits compute,
    # the scheduler pre-stages the spill-resident pages of admitted
    # prefill hits and ready-but-deferred decode streams up to their
    # anchor PU, crediting the fitted fetch time against the committed
    # compute window instead of paying it on the dispatch critical path;
    # eviction becomes hit-frequency-weighted.  Requires ``kv_pages``;
    # off = bit-identical to the PR 6 paging behaviour.
    kv_prefetch: bool = False
    # migration pricing under kv_residency: "modeled" (footprint ÷ link
    # bandwidth) or "constant" (keep the legacy constant while still
    # tracking and charging real transfers — the mischarging baseline the
    # migration-heavy bench regime pits the model against)
    migrate_pricing: str = "modeled"
    # decode-round scoring under the adaptive policy: "mean" member
    # completion (PR 4) or "quantile" (p99-aware: score by a high quantile
    # of member completion, targeting the mixed sparse-arrival tail)
    round_score: str = "mean"
    # batching-cap policy: "fixed" uses the three constants above verbatim
    # (bit-identical to the pre-adaptive scheduler, pinned against
    # committed goldens); "adaptive" derives coalesce/decode caps, the
    # coalesce window, and per-round token groups online from the
    # profiled (width, group) / batch grids (core/batch_policy.py)
    batch_policy: str = "fixed"
    # preemptible fused dispatches: when a higher-SLO-class node is left
    # READY after a pass, an in-flight fused batchable dispatch of lower
    # class may be split at its next member boundary (members past the
    # boundary return READY with their state in place) instead of the
    # cancel-and-redispatch path, which discards completed work and pays
    # a modeled migration.  Off = fused dispatches run whole
    # (bit-identical to the PR 2-7 goldens).
    preempt: bool = False
    # SLO-class, tail-aware admission: nodes carry a query class
    # ("interactive" | "batch"); interactive candidates pierce the Eq. 5
    # gate's batched-mode stand-down, and batch candidates defer while
    # interactive work waits — bounded by the throughput floor below.
    # Off = class-blind admission (bit-identical goldens).
    slo_admission: bool = False
    # throughput floor for batch deferral, in units of the batch class's
    # tracked inter-arrival tau: a deferred batch node that has waited
    # longer than slo_floor_mult × tau dispatches regardless, so batch
    # throughput degrades boundedly under interactive pressure
    slo_floor_mult: float = 4.0
    # speculative decoding (core/spec_decode.py): every decode round may
    # dispatch as a coupled (draft, verify) pair — a small draft model
    # streams ``w`` candidate tokens per verify pass on a possibly
    # *different* PU while the target scores the previous group in one
    # weight sweep, compressing a ``g``-token round into
    # ceil(g / (1 + alpha·w)) passes at the stream's observed accept
    # rate.  Rounds only (requires ``coalesce`` + ``decode_batch``);
    # off = bit-identical to the PR 8 goldens.
    spec_decode: bool = False
    # draft-model registry key (rag.stages.DRAFT_MODELS); None keeps the
    # catalog default the stage set was built with
    draft_model: Optional[str] = None
    # draft width w under the fixed batching policy (candidates proposed
    # per verify pass); the adaptive policy enumerates the profiled
    # (draft_width, verify_group) grid instead
    spec_draft_width: int = 4
    # accept-rate EWMA: prior for never-observed streams (the profiled
    # pair prior wins when the perf model carries one) and the per-round
    # fold-in weight
    spec_accept_init: float = 0.6
    spec_accept_alpha: float = 0.3


@dataclass
class Dispatch:
    node: Node
    pu: str
    batch: int
    predicted_p0: float
    bandwidth: float
    # modeled one-off KV-migration seconds this dispatch pays before its
    # passes start (0 without a residency tracker): both backends add it
    # to the dispatch ETA, and busy-PU candidates see it in busy_until —
    # a queued placement no longer looks cheaper than it is
    migrate_s: float = 0.0


class HeroScheduler:
    def __init__(self, perf: LinearPerfModel, pus: Sequence[str], b0: float,
                 cfg: Optional[SchedulerConfig] = None,
                 template: Optional[WorkflowTemplate] = None):
        self.perf = perf
        self.pus: List[str] = list(pus)      # elastic: may grow/shrink
        self.b0 = b0
        # a fresh config per scheduler: a shared default instance would leak
        # static_map (and any toggle mutation) across schedulers
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.template = template
        self._fifo_seq: Dict[str, int] = {}
        self._seq = 0
        if self.cfg.migrate_pricing not in ("modeled", "constant"):
            raise KeyError(f"migrate_pricing {self.cfg.migrate_pricing!r}; "
                           f"pick from ['modeled', 'constant']")
        # KV tracker: per-stream cache placement + footprints, shared with
        # the DAG (boundary events) and the batching policy.  kv_pages
        # selects the page-table tracker (tiered store + prefix cache);
        # kv_residency the monolithic one; neither = the legacy constant
        if self.cfg.kv_pages:
            self.kv = PagedKVCache(perf,
                                   page_tokens=self.cfg.kv_page_tokens,
                                   prefetch=self.cfg.kv_prefetch)
        elif self.cfg.kv_residency:
            self.kv = KVResidency(perf)
        else:
            self.kv = None
        # batching policy (fixed constants vs online derivation from the
        # profiled grids) + the ready-pool inter-arrival EWMA it consults
        self.policy = make_policy(self.cfg, perf, kv=self.kv)
        self.arrivals = ArrivalTracker()
        # last-seen decode_rounds per resident id: detects boundary
        # re-entries (same node id, another ready-pool arrival)
        self._seen_rounds: Dict[str, int] = {}
        # SLO classes per admitted-query namespace (HeroSession fills this
        # from submit(slo=...)); nodes may also carry payload["slo"]
        self.slo_classes: Dict[str, str] = {}
        # first time each node entered the ready pool (slo_admission only:
        # feeds the batch-deferral throughput floor)
        self._ready_since: Dict[str, float] = {}
        # chosen-shape telemetry per dispatch (benchmarks report these):
        # histograms of resident decode widths, per-round token groups,
        # and fused batchable dispatch sizes
        self.policy_log: Dict[str, Dict[int, int]] = {
            "decode_width": {}, "decode_group": {}, "fused_batch": {}}
        # speculative decoding: online accept-rate tracker — per-stream
        # EWMA the round pricing consults, plus the run totals both
        # backends surface (the ``preemptions`` counter-protocol
        # contract).  The telemetry key is added only when the mode is
        # on so spec-off bench output stays bit-identical.
        if self.cfg.spec_decode:
            self.spec: Optional[SpecTracker] = SpecTracker(
                init=self.cfg.spec_accept_init,
                weight=self.cfg.spec_accept_alpha)
            self.policy_log["spec_width"] = {}
        else:
            self.spec = None

    # -- elastic PU membership (fault tolerance / scale up-down) -----------
    def add_pu(self, pu: str):
        if pu not in self.pus:
            self.pus.append(pu)

    def remove_pu(self, pu: str):
        if pu in self.pus:
            self.pus.remove(pu)

    # -- Alg. 1 -------------------------------------------------------------
    def dispatch_pass(self, dag: DynamicDAG, now: float,
                      idle_pus: Sequence[str], B_now: float,
                      busy_until: Optional[Dict[str, float]] = None,
                      ) -> List[Dispatch]:
        """One scheduling step.  ``busy_until``: estimated release time per
        busy PU — predicted completion F_v(c) is queue-aware, so a critical
        node *defers* for a fast busy PU instead of grabbing a slow idle one
        (the paper's "each stage executes on a single PU" default emerges
        from this, with migration only when genuinely beneficial)."""
        cfgn = self.cfg
        if self.kv is not None and dag.kv is not self.kv:
            # let decode-round boundaries and fuse_decode reach the tracker
            dag.kv = self.kv
        if self.spec is not None and dag.spec is not self.spec:
            # boundary accept counts (_finish_decode_round) feed the EWMA
            # the next round's speculative pricing reads
            dag.spec = self.spec
        crit.update_criticality(dag, self.perf, self.template, now,
                                beta=cfgn.beta if cfgn.enable_criticality
                                else 0.0)                       # line 4
        for n in dag.ready():
            if n.id not in self._fifo_seq:
                self._fifo_seq[n.id] = self._seq
                self._seq += 1
                self._seen_rounds[n.id] = n.payload.get("decode_rounds", 0)
                # ready-pool arrival: feeds the adaptive policy's
                # queueing-delay estimate
                if n.kind != "io":
                    self.arrivals.observe((n.stage, n.kind), now)
                if cfgn.slo_admission:
                    self._ready_since[n.id] = now
                    if n.kind != "io":
                        # per-class arrival rate: the batch class's tau
                        # bounds how long the deferral floor may hold a
                        # batch candidate back
                        self.arrivals.observe(("slo", self._slo_class(n)),
                                              now)
                if (n.kind == "stream_prefill"
                        and getattr(self.kv, "paged", False)):
                    # prefix cache: trim the prefill by its longest
                    # resident page-aligned prefix before any config is
                    # enumerated for it (first-seen = exactly once)
                    self.kv.apply_prefix_hits(n)
            elif (n.payload.get("decode_round")
                  and n.payload.get("members")):
                # a round back in the pool (live-mode straggler
                # cancellation): its workload still carries the previous
                # dispatch's group trim while the residents have advanced
                # — refresh the horizon (and the remainder snapshot the
                # group policy reads) from their true remaining tokens so
                # ETA and group choice see remaining work, not stale
                # padding
                n.payload["remaining"] = sorted(
                    m.workload for m in n.payload["members"])
                n.workload = n.payload["remaining"][-1]
            elif (n.payload.get("decode_rounds", 0)
                  != self._seen_rounds.get(n.id)):
                # a resident re-entering READY at a token-group boundary
                # keeps its node id but IS a fresh ready-pool arrival —
                # the next member a forming batch would wait for; without
                # this, tau freezes after initial admissions in
                # continuous serving
                self._seen_rounds[n.id] = n.payload.get("decode_rounds", 0)
                if n.kind != "io":
                    # boundary re-entry: a real arrival (tau must not
                    # freeze) but NOT a fresh-burst member — the batch's
                    # own boundary says nothing about new-stream rate
                    self.arrivals.observe((n.stage, n.kind), now,
                                          fresh=False)
        fused_new = self._coalesce(dag) if cfgn.coalesce else []
        # Eq. 5 protects a single query's critical path — the right
        # objective in the paper's one-query-at-a-time regime.  A fused
        # node in the graph (ready or in flight) means the scheduler is in
        # batched-serving mode (multiple admitted queries, saturating
        # arrivals): there throughput lives on overlapping work across
        # PUs, so the per-query contention terms stand down and only the
        # absolute B_soft budget (line 11) throttles admission — notably,
        # the gate must not defer the fused dispatch itself.
        batched_mode = False
        for n in dag.ready() + dag.running():
            if "members" in n.payload:
                batched_mode = True
                # a fused node has no successors of its own: its urgency
                # (dispatch order among ready candidates) is its most
                # critical member's, refreshed every pass
                n.criticality = max(m.criticality
                                    for m in n.payload["members"])
        idle = [p for p in idle_pus if p in self.pus or p == "io"]
        busy_until = dict(busy_until or {})
        r_tmp = list(dag.ready())                               # line 5
        decisions: List[Dispatch] = []
        b_soft = cfgn.b_soft_frac * self.b0

        while idle and r_tmp:                                   # line 6
            # absorbed members of an in-flight fused dispatch are RUNNING
            # with config=None — only the fused node (which carries their
            # max criticality and the real config) represents that work
            # here, so members are excluded from the running pool
            running = [n for n in dag.running() if n.config is not None
                       or "fused_into" not in n.payload]
            pool = dag.ready() + running
            v_star = max(pool, key=lambda n: n.criticality,
                         default=None) if pool else None        # line 7
            running_star = (v_star if v_star is not None
                            and v_star.status == RUNNING else
                            next(iter(sorted(running,
                                             key=lambda n: -n.criticality)),
                                 None))
            gate_star = None if batched_mode else running_star
            if cfgn.enable_criticality:
                v_cand = max(r_tmp, key=lambda n: n.criticality)  # line 8
            else:
                v_cand = min(r_tmp, key=lambda n: self._fifo_seq.get(n.id, 0))

            if v_cand.kind == "io":
                # external calls bypass the PU perf model entirely; a node
                # carrying an absolute ``arrival`` payload is an admission
                # timer (HeroSession multi-query) whose remaining delay is
                # its predicted latency
                if "io" in idle:
                    arr = v_cand.payload.get("arrival")
                    p_io = max(arr - now, 0.0) if arr is not None else 0.35
                    dag.mark_running(v_cand.id, now, ("io", 1))
                    decisions.append(Dispatch(v_cand, "io", 1, p_io, 0.0))
                    idle.remove("io")
                r_tmp.remove(v_cand)
                continue

            if (cfgn.slo_admission and self._slo_rank(v_cand) == 0
                    and self._defer_batch(v_cand, r_tmp, idle, now)):
                # batch class stands aside while interactive work waits
                # for a PU it could use — until the throughput floor
                # (slo_floor_mult × batch-class tau) says it has waited
                # long enough
                r_tmp.remove(v_cand)
                continue
            gate_v = self._gate_for(v_cand, gate_star, running_star,
                                    batched_mode) \
                if cfgn.slo_admission else gate_star

            best: Optional[Tuple[float, Dispatch, bool, Optional[Dict]]] \
                = None
            capable = self._capable_pus(v_cand, idle + list(busy_until))
            # speculative decoding precondition for this candidate: a
            # decode round whose stage has a profiled draft companion.
            # alpha is the mean tracker estimate over the member streams
            # (profiled pair prior for never-observed streams).
            spec_ds: Optional[str] = None
            spec_alpha = 0.0
            spec_wpin: Optional[int] = None
            if self.spec is not None and v_cand.payload.get("decode_round"):
                ds0 = draft_stage_of(v_cand.stage)
                mems = v_cand.payload.get("members") or [v_cand]
                # typed per-stage pins (StageSpec.decode = DecodeSpec):
                # a stage pinned to a different draft family than the
                # session's opts out of speculation rather than run under
                # the wrong draft; a width pin bypasses the policy search
                dspec = next((m.payload.get("decode_spec") for m in mems
                              if m.payload.get("decode_spec") is not None),
                             None)
                dm = getattr(dspec, "draft_model", None)
                if dm is not None and self.cfg.draft_model not in (None, dm):
                    ds0 = None
                spec_wpin = getattr(dspec, "draft_width", None)
                prior = (self.perf.spec_accept_init(ds0, v_cand.stage)
                         if ds0 is not None else None)
                if prior is not None:
                    spec_ds = ds0
                    spec_alpha = sum(
                        self.spec.alpha(m.group or m.id, prior)
                        for m in mems) / len(mems)
            # resident decode batch: Eq. 3 enumerates configs at the batch's
            # *current* width, and moving PU pays the KV-migration cost
            width = (v_cand.payload.get("decode_width", 1)
                     if v_cand.payload.get("decode_round") else 1)
            prefer_pu = v_cand.payload.get("prefer_pu")
            for pu in capable:                                  # line 9
                is_idle = pu in idle
                start = now if is_idle else max(now, busy_until[pu])
                for batch in self._configs(v_cand, pu):         # line 10
                    if width > 1:
                        b = self.perf.bandwidth_decode(v_cand.stage, pu,
                                                       width, batch)
                    else:
                        b = self.perf.bandwidth(v_cand.stage, pu, batch)
                    b_active = B_now + sum(x.bandwidth for x in decisions)
                    if is_idle and cfgn.enable_concurrency and \
                            b_active > 0 and cc.violates_budget(
                                b_active, b, b_soft):           # line 11
                        # (gate only actual *concurrency*: a lone stage may
                        # exceed B_soft — waiting cannot help it)
                        continue
                    if width > 1:
                        p0 = self.perf.p0_decode(v_cand.stage, pu, width,
                                                 batch)
                    else:
                        p0 = self.perf.p0(v_cand.stage, pu, batch)
                    phi = self.perf.phi(v_cand.stage, B_now + b)
                    if v_cand.payload.get("decode_round"):
                        # rounds amortize over the residents' remaining
                        # horizon: fixed charges the longest member to
                        # every candidate, adaptive weighs each member's
                        # own remainder (mean completion — the horizon
                        # policy's scoring)
                        passes = self.policy.round_passes(v_cand, batch)
                    else:
                        passes = ceil_passes(v_cand.workload, batch)
                    f_cand = start + passes * p0 * phi          # line 12 (Eq. 2)
                    w_b = cc.contention_penalty(
                        self.perf, gate_v, b, B_now, now
                    ) if (cfgn.enable_concurrency and is_idle) else 0.0
                    score = f_cand + cfgn.alpha * w_b           # line 13 (Eq. 5)
                    mig_s = 0.0
                    if self.kv is not None:
                        # migration priced per stream from tracked
                        # residency — rounds AND solo token-group chains
                        # (which the legacy constant never priced and
                        # which hop PUs freely without it).  f_cand
                        # already amortizes over the remaining horizon,
                        # so the one-off transfer is weighed against the
                        # whole stay: work migrates exactly when the
                        # destination's latency win repays the copy.
                        # The charge rides the Dispatch (migrate_s) so
                        # backend ETAs and busy_until see it too — a
                        # busy-PU candidate queues behind the pending
                        # migration, not just the compute passes.
                        if v_cand.kind == "stream_decode":
                            mig_s = self._migrate_score(v_cand, pu,
                                                        B_now + b)
                            score += mig_s
                    elif (width > 1 and prefer_pu is not None
                          and pu != prefer_pu):
                        # legacy constant: a pure score nudge, never an
                        # ETA term (bit-exact with the kv-off goldens)
                        score += cfgn.decode_migrate_cost
                    if (cfgn.preempt and "members" not in v_cand.payload
                            and v_cand.payload.get("preempt_prefer_pu")
                            is not None
                            and not (self.kv is not None
                                     and v_cand.kind == "stream_decode")):
                        # residency-aware re-placement of a preempted
                        # member: its state stayed put, so anchor to the
                        # KV-resident PU when the tracker knows one, else
                        # the PU it was split off.  A score nudge only
                        # (no ETA term) — stream_decode under a tracker
                        # is excluded because mig_s already prices the
                        # move from true residency.
                        anchor = v_cand.payload["preempt_prefer_pu"]
                        if self.kv is not None:
                            rp = self.kv.resident_pu(v_cand)
                            if rp is not None:
                                anchor = rp
                        if pu != anchor:
                            score += cfgn.decode_migrate_cost
                    d = Dispatch(v_cand, pu, batch, p0, b, mig_s)
                    if best is None or score < best[0]:
                        best = (score, d, is_idle, None)
                    if spec_ds is not None and is_idle:
                        sp = self._spec_plan(v_cand, spec_ds, spec_alpha,
                                             pu, batch, width, idle, start,
                                             B_now, b_active, b_soft,
                                             gate_v, mig_s, now,
                                             wpin=spec_wpin)
                        if sp is not None and (best is None
                                               or sp[0] < best[0]):
                            best = (sp[0], sp[1], True, sp[2])
            if best is None or not best[2]:                     # line 15
                # infeasible now, or better to queue for a busy PU: defer
                r_tmp.remove(v_cand)
                continue
            _, d, _, spec_meta = best
            if (cfgn.enable_concurrency and gate_v is not None
                    and gate_v.id != d.node.id
                    and gate_v.config
                    and gate_v.config[0] != "io"):
                # Eq. 5 admission gate: parallelism is admitted only when it
                # does not significantly impede critical-path progress —
                # defer when the contention damage to v* exceeds the overlap
                # benefit (the candidate's own runtime).
                phi0 = self.perf.phi(gate_v.stage, B_now)
                phi1 = self.perf.phi(gate_v.stage,
                                     B_now + d.bandwidth)
                sp, sb = gate_v.config
                p_star = (self.perf.p0(gate_v.stage, sp, sb)
                          * ceil_passes(gate_v.workload, sb))
                damage = (phi1 - phi0) * p_star
                # dispatch_passes: a decode round's overlap benefit is
                # one token-group pass, not the residents' whole horizon
                # (which is served across later rounds)
                benefit = d.predicted_p0 * dispatch_passes(d.node, d.batch)
                if cfgn.alpha * damage > benefit:
                    r_tmp.remove(v_cand)
                    continue
            piece = self._take_substage(dag, d.node, d.batch)   # Eq. 3 split
            d = dataclasses.replace(d, node=piece)
            if spec_meta is not None:
                self._stamp_spec(piece, spec_meta)
            dag.mark_running(piece.id, now, (d.pu, d.batch))    # line 17
            self._log_choice(piece, d.batch)
            decisions.append(d)
            idle.remove(d.pu)                                   # line 18-19
            passes = ceil_passes(piece.workload, d.batch)
            busy_until[d.pu] = now + passes * d.predicted_p0 + d.migrate_s
            if spec_meta is not None and spec_meta["dp"] != d.pu:
                # cross-PU plan: materialize the draft half as its own
                # dispatch occupying the draft PU for the round
                dd = self._spawn_draft(dag, piece, spec_meta, now)
                decisions.append(dd)
                if dd.pu in idle:
                    idle.remove(dd.pu)
                busy_until[dd.pu] = now + spec_meta["n"] * dd.predicted_p0
            r_tmp = [n for n in dag.ready() if n not in
                     [x.node for x in decisions]]
        if (cfgn.kv_prefetch and decisions
                and getattr(self.kv, "prefetch_on", False)):
            # lookahead hook: the pass just committed compute — overlap
            # the next dispatches' page staging with it
            self._prefetch_pass(dag, decisions, busy_until, now)
        for f in fused_new:
            if f.status == READY:       # never dispatched: dissolve so
                dag.unfuse(f)             # members stay schedulable
                self._fifo_seq.pop(f.id, None)
            elif f.payload.get("decode_round"):
                # dispatched rounds never consult the FIFO again, and one
                # fresh id is minted per token-group boundary — keeping
                # them would leak an entry per boundary in long-lived
                # continuous serving
                self._fifo_seq.pop(f.id, None)
        if cfgn.preempt:
            # `idle` has had every committed dispatch removed, so it is
            # exactly the capacity left over after this pass
            self._preempt_pass(dag, decisions, now, idle)
        return decisions

    # -- SLO classes & preemption ------------------------------------------
    def _slo_class(self, node: Node) -> str:
        """A node's SLO class: its own payload stamp, else its admitted
        query's class (submit(slo=...)), else interactive — unclassified
        work keeps the latency-optimal treatment it always had."""
        cls = node.payload.get("slo")
        if cls is None:
            cls = self.slo_classes.get(self._query_key(node.id),
                                       "interactive")
        return cls

    def _slo_rank(self, node: Node) -> int:
        """Class priority (higher = more latency-sensitive).  A fused
        dispatch ranks as its most sensitive member — a fusion with any
        interactive member is never treated as preemptible batch work."""
        members = node.payload.get("members")
        if members:
            return max(self._slo_rank(m) for m in members)
        return 1 if self._slo_class(node) == "interactive" else 0

    def _defer_batch(self, v: Node, r_tmp: Sequence[Node],
                     idle: Sequence[str], now: float) -> bool:
        """Should batch-class candidate ``v`` stand aside this pass?
        Only while some interactive node is waiting for an idle PU that
        could actually serve it (deferring for unservable work is pure
        starvation), and only until ``v`` has waited past the throughput
        floor: ``slo_floor_mult`` × the batch class's inter-arrival tau.
        With no tau yet (fewer than two batch arrivals) the floor cannot
        be priced and interactive keeps priority."""
        waiting = [n for n in r_tmp
                   if n is not v and n.kind != "io"
                   and self._slo_rank(n) >= 1
                   and self._capable_pus(n, idle)]
        if not waiting:
            return False
        tau_b = self.arrivals.tau(("slo", "batch"))
        members = v.payload.get("members") or [v]
        # a preemption release restarts the member's deferral clock
        # (payload["preempt_t"]): the floor prices a full waiting window
        # from the split, not from the original arrival — otherwise a
        # released member's window is already spent and it re-dispatches
        # straight back into the contention it was split to relieve
        since = min(max(self._ready_since.get(m.id, now),
                        m.payload.get("preempt_t", 0.0))
                    for m in members)
        if tau_b is not None and (now - since) > \
                self.cfg.slo_floor_mult * tau_b:
            return False
        return True

    def _gate_for(self, v: Node, gate_star: Optional[Node],
                  running_star: Optional[Node],
                  batched_mode: bool) -> Optional[Node]:
        """Class-aware Eq. 5 gate: the candidate faces the contention
        gate only against running work of equal-or-higher class.  An
        interactive candidate pierces the gate a batch v* would impose;
        a batch candidate in batched mode loses the stand-down and faces
        the gate the running critical node imposes (batched_mode exists
        to protect cross-query throughput — batch-class work is exactly
        the traffic that may be throttled for it)."""
        rank = self._slo_rank(v)
        if gate_star is not None and rank > self._slo_rank(gate_star):
            return None
        if (gate_star is None and batched_mode and running_star is not None
                and running_star.config
                and running_star.config[0] != "io"
                and rank < self._slo_rank(running_star)):
            return running_star
        return gate_star

    def preempt_price(self, node: Node, now: float) -> float:
        """Modeled cost of splitting ``node`` at its next member
        boundary: zero — no completed member work is discarded, the
        in-progress member finishes, and released members' KV/state
        stays put (re-placement anchors to it)."""
        return 0.0

    def cancel_price(self, node: Node, now: float) -> float:
        """Modeled cost of the legacy cancel-and-redispatch: every
        second of completed work since dispatch is discarded, and each
        member pays a re-placement migration (the constant — cancel
        drops placement state, so the modeled per-stream price is not
        even available).  Strictly positive for any running dispatch,
        so preemption is always priced cheaper."""
        members = node.payload.get("members") or [node]
        lost = max(now - node.start, 0.0) if node.start >= 0 else 0.0
        return lost + self.cfg.decode_migrate_cost * len(members)

    def _preempt_pass(self, dag: DynamicDAG, decisions: List[Dispatch],
                      now: float, idle_left: Sequence[str]) -> None:
        """Flag in-flight fused batchable dispatches for a boundary
        split: if a higher-class node is still READY after this pass
        AND genuinely starved — no idle PU left that could serve it, so
        a running fusion on one of its capable PUs is what blocks it —
        that fusion gets ``payload["preempt_split"]`` whenever the split
        is priced cheaper than cancellation; the backend performs the
        split at the member boundary nearest its true progress (decode
        rounds already yield at token-group boundaries and are left
        alone).  A ready node that merely *deferred* for a busy fast PU
        while capable capacity sat idle is not starved — splitting for
        it would release members into pure contention churn."""
        dispatched = {d.node.id for d in decisions}
        blocked = [b for b in dag.ready()
                   if b.kind != "io" and b.id not in dispatched
                   and self._slo_rank(b) > 0
                   and not self._capable_pus(b, idle_left)]
        if not blocked:
            return
        for n in dag.running():
            if ("members" not in n.payload
                    or n.payload.get("decode_round")
                    or n.config is None or n.config[0] == "io"
                    or n.payload.get("preempt_split")
                    # bounded preemption: a member is released at most
                    # once — re-splitting a fusion of already-released
                    # members trades no new capacity for another round
                    # of re-dispatch churn (and its bandwidth contention
                    # is exactly what slows the interactive work the
                    # split is meant to protect)
                    or any(m.payload.get("preemptions", 0)
                           for m in n.payload["members"])):
                continue
            rank = self._slo_rank(n)
            for b in blocked:
                if (self._slo_rank(b) > rank
                        and n.config[0] in self._capable_pus(b, self.pus)
                        and self.preempt_price(n, now)
                        < self.cancel_price(n, now)):
                    n.payload["preempt_split"] = True
                    break

    # -- predictive prefetch ---------------------------------------------------
    def _prefetch_pass(self, dag: DynamicDAG, decisions: List[Dispatch],
                       busy_until: Dict[str, float], now: float) -> None:
        """Lookahead staging after a committed dispatch pass: the compute
        just dispatched opens an overlap window (the latest non-io
        ``busy_until`` minus ``now``, in modeled seconds); spend it
        pre-staging the spill-resident pages the *next* dispatches will
        gather — (a) admitted prefills whose prefix hit demoted pages
        stage those hits onto their own PU (the decode that adopts them
        anchors there), then (b) ready-but-deferred decode streams stage
        toward their anchor.  The transfer queue is serial, so one
        budget is debited sequentially across all stagings; dispatched
        decode rounds are NOT prefetched — their gather runs now, with
        no compute ahead of it to hide behind."""
        window = max((t for p, t in busy_until.items() if p != "io"),
                     default=now)
        budget = window - now
        if budget <= 0.0:
            return
        dispatched = {d.node.id for d in decisions}
        for d in decisions:
            if budget <= 0.0:
                return
            pids = d.node.payload.get("kv_hit_pages")
            if pids and d.pu != "io":
                budget -= self.kv.prefetch(d.node, d.pu, budget, pids=pids)
        for n in dag.ready():
            if n.kind != "stream_decode" or n.id in dispatched:
                continue
            for m in _kv_members(n):
                if budget <= 0.0:
                    return
                st = self.kv.tracked(m)
                if st is None:
                    continue
                dst = st.pu or m.payload.get("batch_pu")
                if dst is not None:
                    budget -= self.kv.prefetch(m, dst, budget)

    # -- cross-query coalescing ----------------------------------------------
    @staticmethod
    def _query_key(nid: str) -> str:
        """Admitted-query namespace of a node id (HeroSession prefixes
        shared-DAG nodes with ``q<i>/``; un-prefixed ids share one key)."""
        return nid.split("/", 1)[0] if "/" in nid else ""

    def _coalesce(self, dag: DynamicDAG) -> List[Node]:
        """Group READY batchable nodes that share a (stage, kind) key
        across different admitted queries and fuse each group into one
        dispatch unit.  The fused node then flows through the normal
        Alg. 1 machinery: ``shape_aware_configs`` enumerates tile-aligned
        merged configs (capped at ``coalesce_cap``) and the Eq. 5 gate
        prunes them like any other candidate.  Fusions that do not
        dispatch this pass are dissolved before returning.

        With ``decode_batch``, READY ``stream_decode`` nodes group the same
        way into *decode rounds* (continuous batching): each round serves
        one token group per resident stream, so membership is re-derived at
        every boundary — unfinished members return READY and re-fuse here,
        newly READY streams join, finished ones have already left."""
        cfgn = self.cfg
        groups: Dict[Tuple[str, str], List[Node]] = {}
        for n in dag.ready():
            if ("members" in n.payload or n.payload.get("no_coalesce")):
                continue
            if n.kind == "batchable" or (n.kind == "stream_decode"
                                         and cfgn.decode_batch):
                groups.setdefault((n.stage, n.kind), []).append(n)
        created: List[Node] = []
        for (_, kind), nodes in groups.items():
            if len({self._query_key(n.id) for n in nodes}) < 2:
                continue                   # cross-query only
            # most critical members first; the window bounds PU occupancy.
            # Oversized nodes are skipped (they dispatch solo) rather than
            # blocking fusion of the smaller nodes behind them.
            nodes.sort(key=lambda n: -n.criticality)
            stage = nodes[0].stage
            if kind == "stream_decode":
                # width-beyond-ready compares per-member marginal gains,
                # so it needs the burst-corrected per-member rate
                tau = self.arrivals.tau((stage, kind))
                # KV residency: the cap is derived at the PU the forming
                # round will anchor to (same resolution fuse_decode
                # stamps: agreement, or the largest tracked footprint
                # under conflicting history)
                prefer = resolve_prefer_pu(self.kv, nodes)
                cap = self.policy.decode_width_cap(
                    stage, prefer, tau, [n.workload for n in nodes])
                if self.policy.name == "adaptive":
                    # horizon policy: when the cap binds, prefer residents
                    # closest to leaving (shortest remaining first) so
                    # boundaries release members instead of padding them
                    nodes.sort(key=lambda n: n.workload)
                take = nodes[:cap]
                if len({self._query_key(n.id) for n in take}) < 2:
                    continue
                fused = dag.fuse_decode(take)
            else:
                # the window bounds occupancy until the next arrival
                # *event* (a burst's latecomers starve together, not b×
                # faster), so it keeps the raw gap estimate
                tau = self.arrivals.tau_event((stage, kind))
                window = self.policy.coalesce_window(stage, tau)
                take = []
                total = 0
                for n in nodes:
                    if total + n.workload > window:
                        continue
                    take.append(n)
                    total += n.workload
                if len({self._query_key(n.id) for n in take}) < 2:
                    continue
                fused = dag.fuse_ready(take)
            self._fifo_seq[fused.id] = min(
                self._fifo_seq.get(n.id, self._seq) for n in take)
            created.append(fused)
        return created

    # -- helpers -------------------------------------------------------------
    def _migrate_score(self, node: Node, pu: str, B: float) -> float:
        """Eq. 5 addend for serving round ``node`` on ``pu`` given tracked
        KV residency: the modeled transfer cost of every member whose
        cache lives elsewhere (φ-scaled — the copy rides the shared bus),
        or the legacy constant under ``migrate_pricing="constant"`` / a
        profile without the migration grid."""
        pen = self.kv.migrate_penalty(node, pu, B)
        if pen is None:                  # pre-residency profile: no grid
            prefer = node.payload.get("prefer_pu")
            return (self.cfg.decode_migrate_cost
                    if prefer is not None and pu != prefer else 0.0)
        moving, cost = pen
        if moving == 0:
            return 0.0
        if self.cfg.migrate_pricing == "constant":
            return self.cfg.decode_migrate_cost
        return cost

    # -- speculative decoding ----------------------------------------------
    def _spec_plan(self, node: Node, ds: str, alpha: float, pu: str,
                   batch: int, width: int, idle: Sequence[str],
                   start: float, B_now: float, b_active: float,
                   b_soft: float, gate_v: Optional[Node], mig_s: float,
                   now: float, wpin: Optional[int] = None
                   ) -> Optional[Tuple[float, Dispatch, Dict]]:
        """Best speculative plan for serving round ``node`` on verify PU
        ``pu`` at token group ``batch``: enumerate (draft PU, draft
        width) over the profiled pair grid — the draft may pipeline on
        any other *idle* PU (per-pass cost max(t_d, t_v)) or run
        serially on the verify PU itself (t_d + t_v) — and gate the
        coupled pair's *combined* bandwidth through the same Eq. 5
        budget, so draft traffic can never starve the verify star.
        Returns (score, verify Dispatch, meta) or None when the grid
        offers nothing feasible; the caller compares the score against
        the plain (non-speculative) round candidate."""
        cfgn = self.cfg
        vs = node.stage
        pin = (cfgn.static_map or {}).get(ds)
        best: Optional[Tuple[float, Dispatch, Dict]] = None
        for dp in [pu] + [q for q in idle if q != pu]:
            if dp == "io" or not self.perf.supported(ds, dp):
                continue
            if pin is not None and dp != pin:
                continue
            if wpin:
                # typed DecodeSpec.draft_width pin: snap to the profiled
                # grid (largest fitted width not above the pin) instead
                # of searching the policy's candidate set
                grid = self.perf.spec_width_grid(ds, vs, dp, pu)
                below = [g for g in grid if g <= wpin]
                cands: Sequence[int] = ((max(below) if below
                                         else min(grid),) if grid else ())
            else:
                cands = self.policy.spec_width_candidates(ds, vs, dp, pu,
                                                          alpha)
            for w in cands:
                pair = self.perf.spec_pair_time(ds, vs, dp, pu, w, width)
                bv = self.perf.spec_bandwidth(vs, pu, w, width)
                if pair is None or bv is None:
                    continue
                td, tv = pair
                bd = self.perf.bandwidth_decode(ds, dp, width, w)
                b_pair = bv + bd
                if cfgn.enable_concurrency and b_active > 0 and \
                        cc.violates_budget(b_active, b_pair, b_soft):
                    continue
                n_p = spec_passes(batch, w, alpha)
                cost = max(td, tv) if dp != pu else td + tv
                phi = self.perf.phi(vs, B_now + b_pair)
                horizon = self.policy.round_passes(node, batch)
                f_cand = start + horizon * n_p * cost * phi
                w_b = cc.contention_penalty(self.perf, gate_v, b_pair,
                                            B_now, now) \
                    if cfgn.enable_concurrency else 0.0
                score = f_cand + cfgn.alpha * w_b + mig_s
                if best is None or score < best[0]:
                    # the verify dispatch's ETA is the whole round
                    # (n passes of the pipelined pair); same-PU plans
                    # fold the draft's bandwidth into it, cross-PU
                    # plans give the draft its own dispatch
                    d = Dispatch(node, pu, batch, n_p * cost,
                                 b_pair if dp == pu else bv, mig_s)
                    best = (score, d, {"ds": ds, "dp": dp, "w": w,
                                       "n": n_p, "td": td, "bd": bd,
                                       "alpha": alpha})
        return best

    @staticmethod
    def _stamp_spec(piece: Node, meta: Dict) -> None:
        """Commit the chosen speculative plan onto the round's payload —
        what the backends (ground-truth pass count, draft placement),
        the boundary bookkeeping (accept counters, draft-KV sync) and
        the telemetry read."""
        p = piece.payload
        p["spec_width"] = meta["w"]
        p["spec_draft_stage"] = meta["ds"]
        p["spec_draft_pu"] = meta["dp"]
        p["spec_passes"] = meta["n"]
        p["spec_alpha"] = meta["alpha"]

    def _spawn_draft(self, dag: DynamicDAG, piece: Node, meta: Dict,
                     now: float) -> Dispatch:
        """Materialize the draft half of a cross-PU speculative round:
        its own RUNNING node + Dispatch streaming ``n × w`` candidate
        tokens of the small model on the draft PU while the verify
        dispatch scores them.  The node is terminal — no successors and
        no KV-stream registration (draft-cache residency is synced at
        the verify boundary instead) — and is deleted on completion."""
        n_p, w = meta["n"], meta["w"]
        dn = Node(id=dag.fresh_id(f"{piece.id}.draft"), stage=meta["ds"],
                  kind="stream_decode", workload=n_p * w,
                  payload={"draft_round": True, "draft_for": piece.id,
                           "no_coalesce": True,
                           "decode_width": piece.payload.get(
                               "decode_width", 1),
                           "spec_width": w})
        dag.add(dn)
        dag.mark_running(dn.id, now, (meta["dp"], w))
        return Dispatch(dn, meta["dp"], w, meta["td"], meta["bd"])

    def _log_choice(self, node: Node, batch: int) -> None:
        """Chosen-shape telemetry: resident width + token group per decode
        round, merged batch per fused dispatch (what the serving benchmark
        reports per regime — the observable output of the batching policy)."""
        if node.payload.get("decode_round"):
            w = node.payload.get("decode_width", 1)
            wh = self.policy_log["decode_width"]
            wh[w] = wh.get(w, 0) + 1
            gh = self.policy_log["decode_group"]
            gh[batch] = gh.get(batch, 0) + 1
            sw = node.payload.get("spec_width")
            if sw is not None and "spec_width" in self.policy_log:
                sh = self.policy_log["spec_width"]
                sh[sw] = sh.get(sw, 0) + 1
        elif "members" in node.payload:
            fh = self.policy_log["fused_batch"]
            fh[batch] = fh.get(batch, 0) + 1

    def _capable_pus(self, node: Node, idle: Sequence[str]) -> List[str]:
        if node.kind == "io":
            return ["io"] if "io" in idle else []
        if self.cfg.static_map is not None:
            pinned = self.cfg.static_map.get(node.stage)
            if pinned is not None:
                return [pinned] if pinned in idle else []
        return [p for p in idle
                if p != "io" and self.perf.supported(node.stage, p)]

    def _configs(self, node: Node, pu: str) -> List[int]:
        if node.kind == "io":
            return [max(node.workload, 1)]
        if node.payload.get("decode_round"):
            # one boundary per dispatch: token-group candidates, clipped to
            # the batch's remaining horizon (the dispatch trims to the
            # chosen group; unfinished members re-enter at the boundary).
            # The adaptive policy aligns candidates to the sorted member
            # remainders (per-round group selection — no ragged-tail
            # padding); fixed keeps the static ladder.
            groups = self.policy.round_group_candidates(node)
            if groups is None:
                groups = (self.cfg.token_group, self.cfg.token_group * 2,
                          self.cfg.token_group * 4)
            return shape_aware_configs(self.perf, node, pu,
                                       token_groups=tuple(groups))
        if "members" in node.payload:
            # fused dispatch: coalescing IS a batching decision, so merged
            # shape configs are enumerated even with partitioning ablated
            return shape_aware_configs(self.perf, node, pu,
                                       cap=self.policy.coalesce_cap(
                                           node.stage, pu))
        if not self.cfg.enable_partition:
            return [max(node.workload, 1)]
        return shape_aware_configs(self.perf, node, pu,
                                   token_groups=(self.cfg.token_group,
                                                 self.cfg.token_group * 2,
                                                 self.cfg.token_group * 4))

    def _take_substage(self, dag: DynamicDAG, node: Node, n: int) -> Node:
        """Dispatch an n-sized bite of ``node``; leave the remainder as a
        ready sibling (batchable: parallel; streaming: sequential chain).
        Partitioning is recomputed on the remaining workload at the next
        dispatch (paper §4.2)."""
        L = node.workload
        if node.payload.get("decode_round"):
            # decode rounds serve exactly one token group per member; the
            # remainder stays IN the member streams, which rejoin the pool
            # at the boundary (continuous batching — no rest sibling)
            node.workload = min(L, n)
            return node
        if node.payload.get("draft_round"):
            # a draft half re-pooled by a live straggler cancel runs
            # whole: it is terminal and garbage-collected on completion,
            # so a rest sibling would dangle in the successor map
            return node
        if "members" in node.payload:
            return node    # fused dispatches run whole (membership is fixed)
        if not self.cfg.enable_partition or n >= L or node.kind in (
                "io", "search", "stream_prefill"):
            return node
        rest = Node(id=dag.fresh_id(f"{node.id}.r"), stage=node.stage,
                    kind=node.kind, workload=L - n,
                    deps=set(node.deps), template=node.template,
                    group=node.group or node.id, payload=dict(node.payload))
        for k in ("pu_busy_acc", "decode_served", "decode_total",
                  "decode_rounds", "last_slice", "coalesced", "batch_pu",
                  "round_final", "kv_migrations", "kv_bytes_moved",
                  "spec_drafted", "spec_accepted"):
            rest.payload.pop(k, None)   # batch accounting is per-node
        node.workload = n
        node.group = node.group or node.id
        succ = list(dag.successors(node.id))
        if node.kind == "stream_decode":
            # sequential: remainder continues the stream; downstream triggers
            # and expansion move to the final piece
            rest.deps = {node.id}
            rest.expander, node.expander = node.expander, None
            rest.payload["on_progress"] = node.payload.get("on_progress")
        dag.add(rest)
        if node.kind == "stream_decode":
            for s in succ:
                s.deps.discard(node.id)
                s.deps.add(rest.id)
                dag._succ[node.id].discard(s.id)
                dag._succ[rest.id].add(s.id)
                dag._refresh_status(s)
        else:
            for s in succ:
                dag.add_edge(rest.id, s.id)
        return node


# ---------------------------------------------------------------------------
# baseline strategy factories (paper §6.1)
# ---------------------------------------------------------------------------

def strategy_config(name: str, stages: Dict[str, str]) -> SchedulerConfig:
    """stages: stage-name -> role ('embed'|'rerank'|'search_llm'|'chat'|
    'search'|'io'...) used to build the Ayo-like manual map."""
    def all_to(pu: str) -> Dict[str, str]:
        # FAISS-style vector search stays on CPU in every baseline (§6.1)
        return {s: ("cpu" if r == "search" else pu)
                for s, r in stages.items()}

    if name == "llamacpp_gpu":
        return SchedulerConfig(enable_partition=False,
                               enable_criticality=False,
                               enable_concurrency=False,
                               static_map=all_to("gpu"))
    if name == "powerserve_npu":
        return SchedulerConfig(enable_partition=False,
                               enable_criticality=False,
                               enable_concurrency=False,
                               static_map=all_to("npu"))
    if name == "ayo_like":
        m = {}
        for s, role in stages.items():
            m[s] = {"embed": "npu", "rerank": "npu", "search": "cpu",
                    "search_llm": "npu", "chat": "gpu", "refine": "gpu",
                    "rewrite": "npu", "io": "io"}.get(role, "gpu")
        return SchedulerConfig(enable_partition=False,
                               enable_criticality=False,
                               enable_concurrency=False, static_map=m)
    if name == "hero":
        return SchedulerConfig()
    raise KeyError(name)
