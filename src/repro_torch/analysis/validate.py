"""Pre-run structural validation of workflow specs and task graphs.

``python -m repro_torch.analysis.validate`` validates the builtin W1–W3
specs and their assembled DAGs (the CI fast-leg gate).  Programmatic
use::

    from repro_torch.analysis.validate import ensure_valid
    ensure_valid(spec=my_spec)          # raises SpecValidationError
    issues = validate_spec(my_spec)     # inspect without raising

Wired into ``WorkflowSpec.build_dag(validate=True)`` behind
``SessionOptions.validate_spec``: structural errors (dependency
cycles, unknown deps, colliding branch ids, DecodeSpec pins on
non-decode stages) surface before any node is materialized instead of
as a ``KeyError`` mid-run; convention traps (a ``shared_ctx`` prefill
off the ``*_prefill`` naming convention without a ``kv_stage``
override, prefill/decode family mismatches that would page KV under
the wrong profiled shape) surface as warnings.

Everything here is duck-typed over the spec/DAG attribute surface so
the core build path never imports this module (it is imported lazily,
and only when validation is requested).
"""
from __future__ import annotations

import sys
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

ERROR, WARNING = "error", "warning"


@dataclass(frozen=True)
class SpecIssue:
    code: str        # S0xx/W1xx (spec level), D0xx (graph level)
    where: str       # spec/stage/node the issue anchors to
    message: str
    severity: str = ERROR

    def __str__(self) -> str:
        return f"{self.code} [{self.where}] {self.message}"


class SpecValidationError(ValueError):
    """Raised by :func:`ensure_valid` when error-severity issues exist."""

    def __init__(self, issues: Sequence[SpecIssue]):
        self.issues = list(issues)
        super().__init__(
            "; ".join(str(i) for i in issues[:8])
            + (f" (+{len(issues) - 8} more)" if len(issues) > 8 else ""))


# -- spec-level --------------------------------------------------------------
def _cycle(deps: Dict[str, Set[str]]) -> Optional[List[str]]:
    """One dependency cycle among ``deps`` (id -> dep ids), or None."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {k: WHITE for k in deps}
    stack: List[str] = []

    def visit(u: str) -> Optional[List[str]]:
        color[u] = GRAY
        stack.append(u)
        for v in sorted(deps.get(u, ())):
            if v not in color:
                continue
            if color[v] == GRAY:
                return stack[stack.index(v):] + [v]
            if color[v] == WHITE:
                cyc = visit(v)
                if cyc is not None:
                    return cyc
        stack.pop()
        color[u] = BLACK
        return None

    for k in sorted(deps):
        if color[k] == WHITE:
            cyc = visit(k)
            if cyc is not None:
                return cyc
    return None


def validate_spec(spec) -> List[SpecIssue]:
    """Structural + convention checks over one ``WorkflowSpec``."""
    from repro_torch.core.kv_pages import decode_stage_of
    from repro_torch.core.spec_decode import draft_stage_of

    out: List[SpecIssue] = []
    name = getattr(spec, "name", "<spec>")
    statics = list(getattr(spec, "statics", ()))
    groups = list(getattr(spec, "groups", ()))
    col = getattr(spec, "collector", None)
    ids = [s.id for s in statics]
    by_id = {s.id: s for s in statics}

    # S001: duplicate static ids shadow each other in the id map
    seen: Set[str] = set()
    for sid in ids:
        if sid in seen:
            out.append(SpecIssue("S001", f"{name}/{sid}",
                                 "duplicate static stage id"))
        seen.add(sid)

    # S002: dep must name a static (branch deps may also use tokens)
    for s in statics:
        for d in s.deps:
            if d not in by_id:
                out.append(SpecIssue(
                    "S002", f"{name}/{s.id}",
                    f"dep {d!r} is not a static stage id"))

    # S003: static dependency cycle
    cyc = _cycle({s.id: set(s.deps) & set(by_id) for s in statics})
    if cyc is not None:
        out.append(SpecIssue("S003", f"{name}/{cyc[0]}",
                             "static dependency cycle: "
                             + " -> ".join(cyc)))

    # groups
    for g in groups:
        if g.source not in by_id:
            out.append(SpecIssue(
                "S004", f"{name}/{g.source}",
                "branch-group source is not a static stage id"))
        prev_ok = False
        for bs in g.stages:
            if "{i}" not in bs.id:
                out.append(SpecIssue(
                    "S006", f"{name}/{bs.id}",
                    "branch stage id has no '{i}' placeholder — every "
                    "branch would mint the same node id"))
            for d in bs.deps:
                if d == "$prev" and not prev_ok:
                    out.append(SpecIssue(
                        "S005", f"{name}/{bs.id}",
                        "'$prev' dep on the first stage of a branch"))
                elif d not in ("$source", "$prev") and d not in by_id:
                    out.append(SpecIssue(
                        "S005", f"{name}/{bs.id}",
                        f"branch dep {d!r} is neither '$source'/'$prev' "
                        "nor a static stage id"))
            prev_ok = True

    # collector
    if col is not None:
        if col.base_dep not in by_id:
            out.append(SpecIssue(
                "S007", f"{name}/{col.base_dep}",
                "collector base_dep is not a static stage id"))
        for pf, dc in ((col.refine_prefill, col.refine_decode),
                       (col.chat_prefill, col.chat_decode)):
            if decode_stage_of(pf) != dc:
                out.append(SpecIssue(
                    "W104", f"{name}/{pf}",
                    f"collector prefill stage {pf!r} does not pair with "
                    f"decode stage {dc!r} under the *_prefill/*_decode "
                    "convention — its KV pages would adopt under "
                    f"{decode_stage_of(pf)!r}", WARNING))

    # per-stage conventions
    for s in statics:
        dec = getattr(s, "decode", None)
        if dec is not None and s.kind != "stream_decode" and (
                dec.draft_model is not None or dec.draft_width is not None):
            out.append(SpecIssue(
                "S008", f"{name}/{s.id}",
                "DecodeSpec draft pins (draft_model/draft_width) on a "
                f"{s.kind!r} stage — speculation only applies to "
                "stream_decode stages"))
        if (s.kind == "stream_decode" and dec is not None
                and dec.draft_model is not None
                and draft_stage_of(s.stage) is None):
            out.append(SpecIssue(
                "W106", f"{name}/{s.id}",
                f"draft_model pinned but stage {s.stage!r} is not a "
                "*_decode verify target — no draft companion stage is "
                "derivable, so speculation stays off", WARNING))
        if (s.kind == "stream_prefill"
                and getattr(s, "shared_ctx", None) is not None
                and not s.stage.endswith("_prefill")
                and (dec is None or dec.kv_stage is None)):
            out.append(SpecIssue(
                "W101", f"{name}/{s.id}",
                f"shared_ctx prefill stage {s.stage!r} off the *_prefill "
                "naming convention with no DecodeSpec.kv_stage override "
                "— prefix caching is disabled for it at build time",
                WARNING))
        if s.kind == "stream_decode":
            for d in s.deps:
                dep = by_id.get(d)
                if (dep is not None and dep.kind == "stream_prefill"
                        and dep.stage.endswith("_prefill")
                        and decode_stage_of(dep.stage) != s.stage
                        and (getattr(dep, "decode", None) is None
                             or dep.decode.kv_stage is None)):
                    out.append(SpecIssue(
                        "W103", f"{name}/{dep.id}",
                        f"prefill stage {dep.stage!r} feeds decode stage "
                        f"{s.stage!r} but its pages adopt under "
                        f"{decode_stage_of(dep.stage)!r} — set "
                        "DecodeSpec.kv_stage on the prefill", WARNING))

    # W105: dangling static — produced by no-one's input
    referenced: Set[str] = set()
    for s in statics:
        referenced |= set(s.deps)
    for g in groups:
        referenced.add(g.source)
        for bs in g.stages:
            referenced |= set(bs.deps) - {"$source", "$prev"}
    if col is not None:
        referenced.add(col.base_dep)
    final = None
    for s in reversed(statics):
        if s.kind == "stream_decode":
            final = s.id
            break
    for s in statics:
        if s.id not in referenced and s.id != final and col is None:
            out.append(SpecIssue(
                "W105", f"{name}/{s.id}",
                "static stage is neither depended on nor the final "
                "decode — dead work every query pays", WARNING))
    return out


# -- graph-level -------------------------------------------------------------
def validate_dag(dag) -> List[SpecIssue]:
    """Structural checks over an assembled ``DynamicDAG`` (pre-run)."""
    out: List[SpecIssue] = []
    nodes = dict(getattr(dag, "nodes", {}))

    for nid, n in nodes.items():
        for d in n.deps:
            if d not in nodes:
                out.append(SpecIssue(
                    "D002", nid, f"dep {d!r} is not in the graph"))
        if n.payload.get("no_coalesce") and n.payload.get("batch_pu"):
            out.append(SpecIssue(
                "D003", nid,
                "contradictory directives: no_coalesce (opt out of "
                "fused dispatch) with batch_pu (continuous-batch "
                "residency anchor)"))
        if n.payload.get("decode_round") and not n.payload.get("members"):
            out.append(SpecIssue(
                "D004", nid, "decode_round node without members"))
        if int(n.payload.get("kv_ctx", 0)) < 0:
            out.append(SpecIssue(
                "D005", nid, "negative kv_ctx"))

    cyc = _cycle({nid: set(n.deps) & set(nodes)
                  for nid, n in nodes.items()})
    if cyc is not None:
        out.append(SpecIssue("D001", cyc[0],
                             "dependency cycle: " + " -> ".join(cyc)))
    return out


# -- driver ------------------------------------------------------------------
def ensure_valid(spec=None, dag=None) -> List[SpecIssue]:
    """Validate and enforce: warnings are emitted via ``warnings.warn``;
    error-severity issues raise :class:`SpecValidationError`.  Returns
    the full issue list when nothing fatal was found."""
    issues: List[SpecIssue] = []
    if spec is not None:
        issues += validate_spec(spec)
    if dag is not None:
        issues += validate_dag(dag)
    errors = [i for i in issues if i.severity == ERROR]
    for i in issues:
        if i.severity == WARNING:
            warnings.warn(f"repro_torch.analysis.validate: {i}",
                          RuntimeWarning, stacklevel=2)
    if errors:
        raise SpecValidationError(errors)
    return issues


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Validate the builtin W1–W3 specs and their assembled DAGs."""
    from repro_torch.api.spec import builtin_spec
    from repro_torch.rag import sample_traces

    trace = sample_traces("hotpotqa", 1, seed=11)[0]
    failed = 0
    for wf in ("w1", "w2", "w3"):
        spec = builtin_spec(wf)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)
                ensure_valid(spec=spec)
                ensure_valid(dag=spec.build_dag(trace))
                ensure_valid(dag=spec.build_dag(trace,
                                                fine_grained=False))
        except (SpecValidationError, RuntimeWarning) as e:
            print(f"{wf}: FAIL {e}")
            failed += 1
            continue
        print(f"{wf}: OK ({len(spec.statics)} statics, "
              f"{len(spec.groups)} groups)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
