"""Typed session options — the one configuration surface of
:class:`repro_torch.api.session.HeroSession`.

``HeroSession`` grew one sugar kwarg per serving subsystem (``coalesce``,
``batch_policy``, ``kv_residency``, ``kv_pages``, ``kv_prefetch``) plus a
stringly ``cfg_overrides`` dict; invalid combinations (prefetch without
the paged store) only surfaced deep inside the scheduler.
:class:`SessionOptions` replaces that sprawl: one frozen dataclass that
validates combinations at construction and owns the new ``preempt`` /
``slo_admission`` knobs.  The old kwargs remain as thin
``DeprecationWarning`` shims that build an equivalent ``SessionOptions``.

    sess = HeroSession(options=SessionOptions(coalesce=True,
                                              batch_policy="adaptive",
                                              kv_pages=True,
                                              preempt=True,
                                              slo_admission=True))

``scheduler_overrides()`` folds the typed knobs down to the
``SchedulerConfig`` patch the session applies — only non-default fields
are emitted, so a default ``SessionOptions()`` is indistinguishable from
passing nothing (the baseline strategy configs stay untouched and the
PR 2/PR 3 goldens stay bit-identical).  ``cfg_overrides`` stays as the
escape hatch for the long tail of scheduler knobs; its keys are checked
against ``SchedulerConfig`` at construction, and a typed field set
explicitly wins over the same key in ``cfg_overrides`` (the precedence
the deprecated sugar kwargs always had).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

BATCH_POLICIES = ("fixed", "adaptive")
SLO_CLASSES = ("interactive", "batch")


@dataclass(frozen=True)
class SessionOptions:
    # cross-query batch coalescing (multi-query serving; off for the
    # paper's single-query latency protocol)
    coalesce: bool = False
    # "fixed" keeps the SchedulerConfig constants; "adaptive" derives
    # caps/windows/groups online from the profiled grids
    batch_policy: str = "fixed"
    # per-stream KV-residency tracking with modeled migration pricing
    kv_residency: bool = False
    # paged KV subsystem (tiered store + prefix cache); supersedes the
    # monolithic tracker
    kv_pages: bool = False
    # predictive tier prefetch on the paged store (requires kv_pages)
    kv_prefetch: bool = False
    # preemptible fused dispatches: an in-flight cross-query fused
    # dispatch may be split at its next member boundary when a
    # higher-SLO-class node is left waiting (requires coalesce — fused
    # dispatches only exist under it)
    preempt: bool = False
    # SLO-class, tail-aware admission: interactive queries pierce the
    # Eq. 5 gate's batched-mode stand-down, batch queries defer while
    # interactive work waits and the throughput floor holds
    slo_admission: bool = False
    # speculative decoding: decode rounds may dispatch as coupled
    # (draft, verify) pairs the mapper can place on different PUs
    # (requires coalesce — speculation rides continuous decode rounds)
    spec_decode: bool = False
    # draft-model registry key (rag.stages.DRAFT_MODELS) for spec_decode;
    # None keeps the catalog default the stage set was built with
    draft_model: Optional[str] = None
    # run repro_torch.analysis.validate over every submitted WorkflowSpec (and
    # the assembled DAG) before execution: structural errors (dep cycles,
    # unknown deps, DecodeSpec placement, the kv_stage naming trap) raise
    # SpecValidationError up front instead of failing mid-run
    validate_spec: bool = False
    # escape hatch: raw SchedulerConfig field overrides for knobs with no
    # typed surface (keys validated at construction)
    cfg_overrides: Optional[Mapping[str, Any]] = None

    def __post_init__(self):
        if self.batch_policy not in BATCH_POLICIES:
            raise ValueError(f"batch_policy {self.batch_policy!r}; pick "
                             f"from {BATCH_POLICIES}")
        ov = dict(self.cfg_overrides or {})
        if ov:
            from repro_torch.core.scheduler import SchedulerConfig
            valid = {f.name for f in dataclasses.fields(SchedulerConfig)}
            unknown = sorted(set(ov) - valid)
            if unknown:
                raise ValueError(f"cfg_overrides keys {unknown} are not "
                                 f"SchedulerConfig fields")
        # combination checks run on the *effective* values (a typed knob
        # may legally arrive via cfg_overrides)
        eff = {f.name: ov.get(f.name, getattr(self, f.name))
               for f in dataclasses.fields(type(self))
               if f.name != "cfg_overrides"}
        if eff["kv_prefetch"] and not eff["kv_pages"]:
            raise ValueError("kv_prefetch=True requires kv_pages=True "
                             "(prefetch stages pages of the paged store)")
        if eff["preempt"] and not eff["coalesce"]:
            raise ValueError("preempt=True requires coalesce=True "
                             "(preemption splits fused cross-query "
                             "dispatches, which only exist under "
                             "coalescing)")
        if eff["spec_decode"] and not (eff["coalesce"]
                                       and ov.get("decode_batch", True)):
            raise ValueError("spec_decode=True requires coalesce=True with "
                             "decode_batch on (speculative draft/verify "
                             "pairs ride continuous decode rounds, which "
                             "only exist under multi-query coalescing)")
        if eff["draft_model"] is not None:
            if not eff["spec_decode"]:
                raise ValueError("draft_model is only meaningful with "
                                 "spec_decode=True")
            from repro_torch.rag.stages import DRAFT_MODELS
            if eff["draft_model"] not in DRAFT_MODELS:
                raise ValueError(
                    f"draft_model {eff['draft_model']!r} is not an "
                    f"in-tree draft family; pick from "
                    f"{sorted(DRAFT_MODELS)}")

    def scheduler_overrides(self) -> Dict[str, Any]:
        """The ``SchedulerConfig`` patch this options object denotes:
        ``cfg_overrides`` first, then every typed field that differs from
        its default (typed-field precedence — the sugar-kwarg semantics)."""
        out: Dict[str, Any] = dict(self.cfg_overrides or {})
        for f in dataclasses.fields(type(self)):
            # session-level knobs with no SchedulerConfig counterpart
            if f.name in ("cfg_overrides", "validate_spec"):
                continue
            v = getattr(self, f.name)
            if v != f.default:
                out[f.name] = v
        return out
