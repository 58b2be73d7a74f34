"""Static invariant checking for the scheduler core.

Three tools, one package:

- :mod:`repro_torch.analysis.lint` — AST-based repo-specific rules
  (``python -m repro_torch.analysis.lint src/``): event-name registry
  discipline, SchedulerConfig gate hygiene, ``perf_model.fit()``
  rng-stream ordering, core determinism, BackendRun/QueryResult
  counter pairing.
- :mod:`repro_torch.analysis.validate` — pre-run structural validation of
  :class:`repro_torch.api.spec.WorkflowSpec` and assembled
  :class:`repro_torch.core.dag.DynamicDAG` graphs, wired into
  ``WorkflowSpec.build_dag`` behind ``SessionOptions.validate_spec``.
- :mod:`repro_torch.analysis.tracecheck` — a happens-before checker over
  recorded timeline traces and bench artifacts
  (``python -m repro_torch.analysis.tracecheck [files...]``): per-node
  lifecycle state machines, per-PU serve-interval monotonicity, and
  KV / counter conservation.

The rationale: every PR since PR 5 shipped alongside hand-found
protocol bugs — double-counted spec counters, dangling successor
entries after round GC, leaked soft-overflow accounting — all
violations of *implicit* invariants nothing checked mechanically.
These tools make the invariants explicit and CI-enforced.
"""
_EXPORTS = {
    "Violation": "repro_torch.analysis.lint",
    "lint_paths": "repro_torch.analysis.lint",
    "SpecIssue": "repro_torch.analysis.validate",
    "SpecValidationError": "repro_torch.analysis.validate",
    "ensure_valid": "repro_torch.analysis.validate",
    "validate_dag": "repro_torch.analysis.validate",
    "validate_spec": "repro_torch.analysis.validate",
    "TraceViolation": "repro_torch.analysis.tracecheck",
    "check_trace": "repro_torch.analysis.tracecheck",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    # lazy so `python -m repro_torch.analysis.<tool>` doesn't trip runpy's
    # found-in-sys.modules warning by importing its sibling tools
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
