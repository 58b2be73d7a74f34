"""`HeroSession` — the one entry point for running HeRo workloads.

Owns the expensive, once-per-session setup (SoC spec, ground-truth
profiling, the fitted ``LinearPerfModel``), then serves queries:

    sess = HeroSession(world="sd8gen4", family="qwen3", strategy="hero")
    h0 = sess.submit(trace0, wf=2)
    h1 = sess.submit(trace1, wf=2, arrival_time=4.0)   # admitted at t=4 s
    results = sess.run()                               # List[QueryResult]

- ``backend="sim"`` executes on the event-driven SoC simulator,
  ``backend="live"`` on real ``PUExecutor`` worker threads — same script,
  same scheduler, either substrate (pass a :class:`Backend` instance for
  anything custom).
- ``run(mode="shared")`` merges every submitted query into ONE
  :class:`DynamicDAG` with per-query admission gates (continuous
  multi-query admission: a query whose ``arrival_time`` lies in the
  future is held behind a timer node and released mid-run).
  ``run(mode="isolated")`` instead runs each query on a fresh DAG and a
  fresh scheduler — the single-query latency protocol used by the paper
  benchmarks.
- ``strategy`` picks the scheduler: ``"hero"`` or one of the §6.1
  baselines (``llamacpp_gpu``/``powerserve_npu``/``ayo_like``), with the
  static maps derived from each workflow spec's stage roles.
- All serving-subsystem knobs live on ONE typed object:
  ``options=SessionOptions(...)`` (``repro_torch.api.options``) — ``coalesce``
  (cross-query batch coalescing), ``batch_policy`` ("fixed"|"adaptive"
  caps), ``kv_residency`` (modeled migration pricing), ``kv_pages``
  (tiered paged-KV store + prefix cache), ``kv_prefetch`` (predictive
  tier staging), ``preempt`` (boundary-preemptible fused dispatches),
  ``slo_admission`` (class-aware Eq. 5 gating), plus ``cfg_overrides``
  as the raw :class:`SchedulerConfig` escape hatch.  Combinations are
  validated at construction.  The former per-knob kwargs
  (``coalesce=`` … ``cfg_overrides=``) still work as deprecated shims.
- SLO classes: ``submit(..., slo="interactive"|"batch",
  deadline=seconds)`` tags a query's class (admission/preemption
  optimize interactive p99 under a batch throughput floor when
  ``slo_admission``/``preempt`` are on) and an optional latency budget;
  results report ``slo_class`` / ``deadline_met`` / ``preemptions``.
  ``QueryHandle.cancel()`` withdraws a query — before ``run()`` it is
  simply dropped, mid-run its remaining nodes collapse through the
  backends' cancellation machinery.
- per-query streaming: ``submit(..., on_token=fn, on_stage_done=fn)``.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

from repro_torch.api.backends import Backend, BackendRun, LiveBackend, SimBackend
from repro_torch.api.options import SLO_CLASSES, SessionOptions
from repro_torch.api.results import ADMIT_STAGE, QueryResult, collect_results
from repro_torch.api.spec import WorkflowSpec, builtin_spec
from repro_torch.core.dag import DynamicDAG, Node
from repro_torch.core.events import EV_DONE, EV_TOKENS
from repro_torch.core.perf_model import (GroundTruthPerf, LinearPerfModel, SoCSpec,
                                   snapdragon_8gen3, snapdragon_8gen4)
from repro_torch.core.scheduler import (HeroScheduler, SchedulerConfig,
                                  strategy_config)

SOCS = {"sd8gen3": snapdragon_8gen3, "sd8gen4": snapdragon_8gen4}
STRATEGIES = ("llamacpp_gpu", "powerserve_npu", "ayo_like", "hero")

# (world name | SoCSpec id, family) -> (soc, gt, perf): profiling +
# regression fitting is deterministic and read-only in use, so sessions
# share it (the cached soc keeps an id()-keyed SoCSpec alive)
_WORLD_CACHE: Dict[tuple, tuple] = {}


def make_world(world: Union[str, SoCSpec], family: str):
    """Resolve (SoC spec, ground truth, fitted perf model).  Cached per
    named world — and per :class:`SoCSpec` *instance* (by identity), so
    re-using one custom spec across sessions profiles once."""
    from repro_torch.configs import get_family
    from repro_torch.rag.stages import build_stages

    key = ((world, family) if isinstance(world, str)
           else (id(world), family))
    if key in _WORLD_CACHE:
        return _WORLD_CACHE[key]
    soc = SOCS[world]() if isinstance(world, str) else world
    gt = GroundTruthPerf(soc, build_stages(get_family(family)))
    perf = LinearPerfModel().fit(gt)
    _WORLD_CACHE[key] = (soc, gt, perf)
    return soc, gt, perf


@dataclass
class QueryHandle:
    qid: int
    trace: Any
    spec: WorkflowSpec
    arrival_time: float = 0.0
    on_token: Optional[Callable] = None
    on_stage_done: Optional[Callable] = None
    prefix: str = ""
    result: Optional[QueryResult] = None
    # SLO class ("interactive" | "batch") and optional latency budget in
    # seconds from arrival; results carry them back as slo_class /
    # deadline_met
    slo: str = "interactive"
    deadline: Optional[float] = None
    cancelled: bool = False
    # the DAG this handle's query is executing on (set for the duration
    # of run(); lets cancel() reach the live cancellation machinery)
    _dag: Optional[DynamicDAG] = None

    def cancel(self) -> None:
        """Withdraw this query.  Before ``run()`` it is dropped at
        admission; during a run its remaining nodes are flagged and
        collapse at the backend's next scheduling point (an in-flight
        fused dispatch shared with other queries drains first)."""
        self.cancelled = True
        if self._dag is not None:
            self._dag.request_cancel(self.prefix)


class HeroSession:
    def __init__(self, world: Union[str, SoCSpec] = "sd8gen4",
                 family: str = "qwen3", strategy: str = "hero",
                 backend: Union[str, Backend] = "sim",
                 options: Optional[SessionOptions] = None,
                 cfg_overrides: Optional[dict] = None,
                 coalesce: Optional[bool] = None,
                 batch_policy: Optional[str] = None,
                 kv_residency: Optional[bool] = None,
                 kv_pages: Optional[bool] = None,
                 kv_prefetch: Optional[bool] = None,
                 fine_grained: Optional[bool] = None,
                 means: Optional[dict] = None,
                 pus: Optional[List[str]] = None,
                 sim_opts: Optional[dict] = None,
                 stage_fns: Optional[dict] = None,
                 timeout: float = 3600.0):
        if strategy not in STRATEGIES:
            raise KeyError(f"strategy {strategy!r}; pick from {STRATEGIES}")
        self.soc, self.gt, self.perf = make_world(world, family)
        self.strategy = strategy
        # deprecated per-knob kwargs: thin shims over SessionOptions (the
        # typed surface, which also validates combinations)
        legacy = {k: v for k, v in (("coalesce", coalesce),
                                    ("batch_policy", batch_policy),
                                    ("kv_residency", kv_residency),
                                    ("kv_pages", kv_pages),
                                    ("kv_prefetch", kv_prefetch),
                                    ("cfg_overrides", cfg_overrides))
                  if v is not None}
        if legacy:
            warnings.warn(
                f"HeroSession kwargs {sorted(legacy)} are deprecated; pass "
                f"options=SessionOptions(...) instead",
                DeprecationWarning, stacklevel=2)
            if options is not None:
                # a kwarg repeating the options= value is merely redundant
                # (ported callers that still forward their old kwargs keep
                # working); a *disagreeing* kwarg is ambiguous and raises
                conflicts = sorted(k for k, v in legacy.items()
                                   if getattr(options, k) != v)
                if conflicts:
                    raise ValueError(
                        f"deprecated kwargs {conflicts} conflict with the "
                        f"values in options=; pass options= OR the "
                        f"per-knob kwargs, not both")
                warnings.warn(
                    f"kwargs {sorted(legacy)} are redundant: options= "
                    f"already carries the same values",
                    DeprecationWarning, stacklevel=2)
            else:
                options = SessionOptions(**legacy)
        self.options = options if options is not None else SessionOptions()
        self.cfg_overrides = self.options.scheduler_overrides()
        self.fine_grained = fine_grained
        self.means = means
        self.pus = list(pus) if pus is not None else [p.name
                                                      for p in self.soc.pus]
        self.timeout = timeout
        if backend == "sim":
            self.backend: Backend = SimBackend(self.gt, **(sim_opts or {}))
        elif backend == "live":
            self.backend = LiveBackend(stage_fns=stage_fns)
        elif isinstance(backend, str):
            raise KeyError(f"backend {backend!r}; pick 'sim', 'live', or "
                           f"pass a Backend instance")
        else:
            self.backend = backend
        self._handles: List[QueryHandle] = []
        self.last_run: Optional[BackendRun] = None

    # -- admission -----------------------------------------------------------
    def submit(self, trace, wf: Optional[int] = None,
               spec: Optional[WorkflowSpec] = None,
               arrival_time: float = 0.0,
               slo: str = "interactive",
               deadline: Optional[float] = None,
               on_token: Optional[Callable] = None,
               on_stage_done: Optional[Callable] = None) -> QueryHandle:
        """Queue one query.  ``wf`` selects a builtin workflow (1-3);
        ``spec`` supplies a custom :class:`WorkflowSpec` instead.
        ``arrival_time`` is run-relative (simulated seconds on the sim
        backend, wall seconds on the live backend); the query's root
        stages are gated until then.  ``slo`` tags the query's class
        ("interactive" holds p99, "batch" fills throughput — acted on
        when ``SessionOptions.slo_admission``/``preempt`` are on);
        ``deadline`` is an optional latency budget in seconds from
        arrival, reported back as ``QueryResult.deadline_met``."""
        if spec is None:
            spec = builtin_spec(wf if wf is not None else 2)
        elif wf is not None:
            raise ValueError("pass either wf= or spec=, not both")
        if slo not in SLO_CLASSES:
            raise ValueError(f"slo {slo!r}; pick from {SLO_CLASSES}")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be positive, got {deadline}")
        h = QueryHandle(qid=len(self._handles), trace=trace, spec=spec,
                        arrival_time=float(arrival_time),
                        slo=slo, deadline=deadline,
                        on_token=on_token, on_stage_done=on_stage_done)
        self._handles.append(h)
        return h

    @property
    def queries(self) -> List[QueryHandle]:
        return list(self._handles)

    def reset(self) -> None:
        """Drop queued queries AND the previous run's residue: the last
        :class:`BackendRun` and the handles' backend attachments (a
        reset session used to keep serving stale ``last_run`` state)."""
        for h in self._handles:
            h._dag = None
        self._handles = []
        self.last_run = None

    # -- execution -----------------------------------------------------------
    def run(self, mode: str = "shared",
            timeout: Optional[float] = None) -> List[QueryResult]:
        """Execute every submitted query and return their results (in
        submit order).  ``mode="shared"``: one DAG, one scheduler,
        per-query admission gates.  ``mode="isolated"``: fresh DAG +
        scheduler per query (arrival times ignored) — the paper's
        single-query latency protocol."""
        # queries cancelled before the run starts are simply dropped
        self._handles = [h for h in self._handles if not h.cancelled]
        if not self._handles:
            return []
        timeout = timeout if timeout is not None else self.timeout
        if mode == "shared":
            results = self._run_shared(timeout)
        elif mode == "isolated":
            results = self._run_isolated(timeout)
        else:
            raise ValueError(f"mode {mode!r}; pick 'shared' or 'isolated'")
        self._handles = []
        return results

    def _run_shared(self, timeout: float) -> List[QueryResult]:
        handles = self._handles
        specs, seen = [], set()
        for h in handles:
            if h.spec.name not in seen:
                seen.add(h.spec.name)
                specs.append(h.spec)
        cfg = self._scheduler_cfg(specs)
        fine = (self.fine_grained if self.fine_grained is not None
                else cfg.enable_partition)
        dag = DynamicDAG()
        solo = len(handles) == 1
        for h in handles:
            h.prefix = "" if solo else f"q{h.qid}/"
            gate = None
            if h.arrival_time > 0:
                gate = dag.add(Node(id=f"{h.prefix}admit", stage=ADMIT_STAGE,
                                    kind="io", workload=1,
                                    payload={"arrival": h.arrival_time})).id
            h.spec.build_dag(h.trace, fine_grained=fine, prefix=h.prefix,
                             dag=dag, gate_dep=gate,
                             validate=self.options.validate_spec)
            h._dag = dag    # cancel() routes through the live DAG
        if self.options.validate_spec:
            # graph-level pass over the assembled multi-query DAG
            # (cross-query issues a single spec cannot see)
            from repro_torch.analysis.validate import ensure_valid
            ensure_valid(dag=dag)
        sched = self._scheduler(cfg, specs)
        # query-namespace -> SLO class: covers every node of the query,
        # including ones expanders create mid-run
        sched.slo_classes = {(h.prefix[:-1] if h.prefix else ""): h.slo
                             for h in handles}
        try:
            run = self.backend.execute(dag, sched,
                                       observer=self._observer(handles),
                                       timeout=timeout)
        finally:
            for h in handles:
                h._dag = None
        self.last_run = run
        return collect_results(dag, handles, run, self.backend.name)

    def _run_isolated(self, timeout: float) -> List[QueryResult]:
        out: List[QueryResult] = []
        for h in self._handles:
            h.prefix = ""
            h.arrival_time = 0.0   # no gate in isolated mode: each query
            # runs from t=0 on its own DAG, so results must not offset by it
            cfg = self._scheduler_cfg([h.spec])
            fine = (self.fine_grained if self.fine_grained is not None
                    else cfg.enable_partition)
            dag = h.spec.build_dag(h.trace, fine_grained=fine,
                                   validate=self.options.validate_spec)
            h._dag = dag
            sched = self._scheduler(cfg, [h.spec])
            sched.slo_classes = {"": h.slo}
            try:
                run = self.backend.execute(dag, sched,
                                           observer=self._observer([h]),
                                           timeout=timeout)
            finally:
                h._dag = None
            self.last_run = run
            out.extend(collect_results(dag, [h], run, self.backend.name))
        return out

    # -- internals -----------------------------------------------------------
    def _scheduler_cfg(self, specs: List[WorkflowSpec]) -> SchedulerConfig:
        if self.strategy == "hero":
            cfg = SchedulerConfig()
        else:
            # baseline static maps must pin every stage of every submitted
            # workflow, not just the first one's
            roles: Dict[str, str] = {}
            for spec in specs:
                for stage, role in spec.stage_roles().items():
                    roles.setdefault(stage, role)
            cfg = strategy_config(self.strategy, roles)
        if self.cfg_overrides:
            cfg = dataclasses.replace(cfg, **self.cfg_overrides)
        return cfg

    def _scheduler(self, cfg: SchedulerConfig,
                   specs: List[WorkflowSpec]) -> HeroScheduler:
        template = None
        if cfg.enable_criticality and (self.strategy == "hero"
                                       or self.cfg_overrides):
            means = self._template_means()
            template = specs[0].build_template(means)
            for spec in specs[1:]:   # mixed workflows: union of priors
                for sid, ts in spec.build_template(means).stages.items():
                    template.stages.setdefault(sid, ts)
        return HeroScheduler(self.perf, self.pus, self.soc.dram_bw, cfg,
                             template=template)

    def _template_means(self):
        """Historical means for the Eq. 4 prior: explicit ``means=`` if
        given, else the field-wise mean over every submitted trace (all
        numeric fields, so custom-spec workload formulas resolve too)."""
        if self.means is not None:
            return self.means
        from repro_torch.api.spec import View
        views = [View.of(h.trace).__dict__ for h in self._handles]
        means: Dict[str, float] = {}
        for key in set().union(*views):
            vals = [v[key] for v in views
                    if isinstance(v.get(key), (int, float))]
            if len(vals) == len(views):
                means[key] = float(sum(vals)) / len(vals)
        return means

    def _observer(self, handles: List[QueryHandle]):
        routed = [h for h in handles if h.on_token or h.on_stage_done]
        if not routed:
            return None
        # longest prefix first so "" (solo) never shadows real prefixes
        routed.sort(key=lambda h: -len(h.prefix))

        def observer(t: float, event: str, node: Node):
            # "done": a node (or solo decode piece) finished; "tokens": a
            # resident continuous-batching member advanced one token group
            # at a decode-round boundary without finishing
            if (event not in (EV_DONE, EV_TOKENS)
                    or node.stage == ADMIT_STAGE):
                return
            for h in routed:
                if not node.id.startswith(h.prefix):
                    continue
                if event == EV_DONE and h.on_stage_done is not None:
                    h.on_stage_done(h, node, t)
                if (h.on_token is not None and node.kind == "stream_decode"
                        and node.template == h.spec.final_decode()):
                    # one callback per finished token group (sub-stage
                    # partitioning or decode-round boundaries make this the
                    # streaming granularity)
                    tokens = (node.payload["last_slice"]
                              if event == EV_TOKENS else node.workload)
                    h.on_token(h, tokens, t)
                break

        return observer
