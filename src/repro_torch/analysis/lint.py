"""Repo-specific AST lint for the scheduler core.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/

Rules (each encodes an invariant a past PR re-derived by hand):

- **EVT001** — in the event-handling modules, timeline-event names must
  come from the ``EV_*`` registry in ``repro_torch.core.events``: raw string
  literals in ``_note``/``_emit`` calls, ``_events.append`` tuples, or
  comparisons are rejected.  A typo'd emit fails *silently* today —
  the event lands on the timeline and every counter filter misses it.
- **EVT002** — a compared string within edit distance 1 of a registered
  event name is flagged as a probable typo even where raw strings are
  otherwise allowed.
- **CFG001** — every boolean ``SchedulerConfig`` knob defaults off
  unless declared in ``scheduler.BASELINE_ON_KNOBS``: a gate that
  defaults on silently changes the goldens' baseline physics.
- **CFG002** — every feature gate (boolean knob defaulting off) is
  actually *consulted*: read in a boolean context (``if``/``and``/
  ``not``/ternary) or passed through as a same-named keyword argument
  somewhere in the linted tree.  An unread gate means the feature
  cannot be turned off.
- **RNG001/RNG002** — in ``perf_model.fit()``, noiseless grid fits
  must come *after* every noisy (rng-drawing) fit, and ``rng`` must be
  bound exactly once via ``np.random.default_rng(seed)``.  This is the
  golden-bit-identity rule: a new grid drawing rng before an existing
  stream shifts every downstream sample.
- **DET001/DET002/DET003** — no ``time``/``random`` imports, no legacy
  ``np.random.<dist>`` calls, and no unseeded ``default_rng()`` in
  ``core/`` (the deterministic substrate); seeded
  ``np.random.default_rng(seed)`` is the one sanctioned rng.
- **CNT001** — every ``BackendRun`` counter has a matching
  ``QueryResult`` attribution field or is declared in
  ``backends.RUN_ONLY_COUNTERS`` (global-pressure counters that have
  no per-query attribution by design).

Adding a rule: write a ``check_*(tree, key, path)`` (per-file) or
``check_*(trees)`` (cross-file) function returning ``Violation``s and
register it in :func:`lint_paths`; add one positive + one negative
case to ``tests/test_analysis_lint.py``.
"""
from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.events import ALL_EVENTS


@dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# modules that emit or dispatch on timeline events: raw event-string
# literals are banned here (the registry itself is exempt)
EVENT_MODULES = frozenset({
    "core/simulator.py", "core/kv_pages.py", "core/scheduler.py",
    "serving/executor.py", "api/backends.py", "api/results.py",
    "api/session.py",
})

# core/ modules allowed to use wall clock / stdlib random (none today;
# the sanctioned rng is seeded np.random.default_rng, allowed anywhere)
SANCTIONED_DET_MODULES: frozenset = frozenset()

# BackendRun fields that are structure, not counters (no pairing needed)
STRUCTURAL_RUN_FIELDS = frozenset({"events", "batching"})


def _module_key(path: str) -> str:
    """``.../src/repro/core/simulator.py -> core/simulator.py`` — the
    repo-relative module identity rules dispatch on."""
    p = Path(path).as_posix()
    i = p.rfind("repro/")
    return p[i + len("repro/"):] if i >= 0 else Path(p).name


# -- EVT: event-name registry discipline -------------------------------------
def _lev_le1(a: str, b: str) -> bool:
    """Levenshtein distance <= 1 (a != b assumed)."""
    if a == b:
        return True
    la, lb = len(a), len(b)
    if abs(la - lb) > 1:
        return False
    if la == lb:                       # one substitution
        return sum(x != y for x, y in zip(a, b)) <= 1
    if la > lb:
        a, b, la, lb = b, a, lb, la
    # one insertion into a
    i = 0
    while i < la and a[i] == b[i]:
        i += 1
    return a[i:] == b[i + 1:]


def _near_event(s: str) -> Optional[str]:
    """The registered event ``s`` is probably a typo of, or None."""
    if s in ALL_EVENTS or not (3 <= len(s) <= 20):
        return None
    for ev in sorted(ALL_EVENTS):
        if _lev_le1(s, ev):
            return ev
    return None


def _str_operands(node: ast.expr) -> List[Tuple[int, str]]:
    """String constants a comparison operand contributes: the operand
    itself, or the elements of a tuple/list/set literal (membership)."""
    out: List[Tuple[int, str]] = []
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        out.append((node.lineno, node.value))
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append((e.lineno, e.value))
    return out


def check_event_literals(tree: ast.AST, key: str,
                         path: str) -> List[Violation]:
    if key not in EVENT_MODULES:
        return []
    out: List[Violation] = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            # self._note(timeline, t, event, node) / self._emit(t, ev, n)
            if n.func.attr in ("_note", "_emit") and len(n.args) >= 2:
                ev_arg = n.args[-2]
                if (isinstance(ev_arg, ast.Constant)
                        and isinstance(ev_arg.value, str)):
                    out.append(Violation(
                        path, ev_arg.lineno, "EVT001",
                        f"raw event string {ev_arg.value!r} in "
                        f"{n.func.attr}() — use the EV_* constant from "
                        "repro_torch.core.events"))
            # self._events.append(("name", node))
            elif (n.func.attr == "append"
                  and isinstance(n.func.value, ast.Attribute)
                  and n.func.value.attr == "_events" and n.args):
                tup = n.args[0]
                if isinstance(tup, (ast.Tuple, ast.List)) and tup.elts:
                    first = tup.elts[0]
                    if (isinstance(first, ast.Constant)
                            and isinstance(first.value, str)):
                        out.append(Violation(
                            path, first.lineno, "EVT001",
                            f"raw event string {first.value!r} queued on "
                            "_events — use the EV_* constant from "
                            "repro_torch.core.events"))
        elif isinstance(n, ast.Compare):
            for op in [n.left] + list(n.comparators):
                for line, s in _str_operands(op):
                    if s in ALL_EVENTS:
                        out.append(Violation(
                            path, line, "EVT001",
                            f"comparison against raw event string {s!r} "
                            "— use the EV_* constant from "
                            "repro_torch.core.events"))
                    else:
                        near = _near_event(s)
                        if near is not None:
                            out.append(Violation(
                                path, line, "EVT002",
                                f"string {s!r} looks like a typo of "
                                f"event {near!r} — typo'd event names "
                                "silently drop counters"))
    return out


# -- CFG: SchedulerConfig gate hygiene ---------------------------------------
def _frozenset_literal(node: ast.expr) -> Optional[Set[str]]:
    """Strings of a ``frozenset({...})`` / set-literal assignment."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "frozenset" and node.args):
        node = node.args[0]
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        vals = set()
        for e in node.elts:
            if not (isinstance(e, ast.Constant)
                    and isinstance(e.value, str)):
                return None
            vals.add(e.value)
        return vals
    return None


def _bool_fields(cls: ast.ClassDef) -> List[Tuple[str, bool, int]]:
    """(name, default, lineno) of every ``x: bool = ...`` field."""
    out = []
    for st in cls.body:
        if (isinstance(st, ast.AnnAssign)
                and isinstance(st.target, ast.Name)
                and isinstance(st.annotation, ast.Name)
                and st.annotation.id == "bool"
                and isinstance(st.value, ast.Constant)
                and isinstance(st.value.value, bool)):
            out.append((st.target.id, st.value.value, st.lineno))
    return out


def _gated_reads(tree: ast.AST) -> Set[str]:
    """Attribute names read in a boolean context (``if``/``while``/
    ``and``/``or``/``not``/ternary/assert/comprehension-filter) or
    passed through as a same-named keyword argument."""
    conds: List[ast.expr] = []
    reads: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            conds.append(n.test)
        elif isinstance(n, ast.BoolOp):
            conds.extend(n.values)
        elif isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
            conds.append(n.operand)
        elif isinstance(n, ast.comprehension):
            conds.extend(n.ifs)
        elif isinstance(n, ast.keyword) and n.arg is not None:
            # cfg pass-through: PagedKVCache(..., prefetch=cfg.kv_prefetch)
            # delegates the gate to the callee — the knob is consulted
            if isinstance(n.value, ast.Attribute):
                reads.add(n.value.attr)
    for c in conds:
        for m in ast.walk(c):
            if isinstance(m, ast.Attribute):
                reads.add(m.attr)
    return reads


def check_config_gates(trees: Dict[str, ast.AST]) -> List[Violation]:
    sched_path = next((p for p in trees
                       if _module_key(p) == "core/scheduler.py"), None)
    if sched_path is None:
        return []
    tree = trees[sched_path]
    cls = next((n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
                and n.name == "SchedulerConfig"), None)
    if cls is None:
        return []
    baseline: Set[str] = set()
    for n in ast.walk(tree):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "BASELINE_ON_KNOBS"):
            baseline = _frozenset_literal(n.value) or set()
    out: List[Violation] = []
    reads: Set[str] = set()
    for t in trees.values():
        reads |= _gated_reads(t)
    for name, default, line in _bool_fields(cls):
        if default and name not in baseline:
            out.append(Violation(
                sched_path, line, "CFG001",
                f"boolean knob {name!r} defaults on — feature gates "
                "must default off (or be declared in BASELINE_ON_KNOBS "
                "with a rationale)"))
        if not default and name not in reads:
            out.append(Violation(
                sched_path, line, "CFG002",
                f"feature gate {name!r} is never consulted in a boolean "
                "context — the feature cannot be switched off"))
    return out


# -- RNG: perf_model.fit() stream ordering -----------------------------------
def _draws_rng(node: ast.AST, noisy_helpers: Set[str]) -> bool:
    for m in ast.walk(node):
        if isinstance(m, ast.Call):
            f = m.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "rng"):
                return True
            name = (f.attr if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else None)
            if name in noisy_helpers:
                return True
    return False


def _assigns_self(node: ast.AST) -> bool:
    def _root_is_self(t: ast.expr) -> bool:
        while isinstance(t, (ast.Subscript, ast.Attribute)):
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                return True
            t = t.value
        return False

    for m in ast.walk(node):
        if isinstance(m, ast.Assign):
            if any(_root_is_self(t) for t in m.targets):
                return True
        elif isinstance(m, (ast.AugAssign, ast.AnnAssign)):
            if _root_is_self(m.target):
                return True
    return False


def check_fit_rng_order(tree: ast.AST, key: str,
                        path: str) -> List[Violation]:
    if key != "core/perf_model.py":
        return []
    noisy_helpers = {
        fn.name for fn in ast.walk(tree)
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        and "rng" in [a.arg for a in fn.args.args + fn.args.kwonlyargs]
        and any(isinstance(m, ast.Call)
                and isinstance(m.func, ast.Attribute)
                and isinstance(m.func.value, ast.Name)
                and m.func.value.id == "rng" for m in ast.walk(fn))
    }
    fit = next((n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == "fit"),
               None)
    if fit is None:
        return []
    out: List[Violation] = []
    rng_binds = [st for st in fit.body if isinstance(st, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == "rng"
                         for t in st.targets)]
    ok_bind = (len(rng_binds) == 1
               and isinstance(rng_binds[0].value, ast.Call)
               and isinstance(rng_binds[0].value.func, ast.Attribute)
               and rng_binds[0].value.func.attr == "default_rng"
               and rng_binds[0].value.args)
    if not ok_bind:
        out.append(Violation(
            path, fit.lineno, "RNG002",
            "fit() must bind rng exactly once, via "
            "np.random.default_rng(seed)"))
    flags = [(st, _draws_rng(st, noisy_helpers), _assigns_self(st))
             for st in fit.body]
    last_noisy = max((i for i, (_, noisy, _a) in enumerate(flags)
                      if noisy), default=-1)
    for i, (st, noisy, selfa) in enumerate(flags):
        if i < last_noisy and not noisy and selfa:
            out.append(Violation(
                path, st.lineno, "RNG001",
                "noiseless grid fit precedes a noisy (rng-drawing) fit "
                f"at line {flags[last_noisy][0].lineno} — new profiled "
                "grids must draw AFTER all previously-fitted streams, "
                "or golden bit-identity breaks"))
    return out


# -- DET: determinism in core/ -----------------------------------------------
def check_core_determinism(tree: ast.AST, key: str,
                           path: str) -> List[Violation]:
    if not key.startswith("core/") or key in SANCTIONED_DET_MODULES:
        return []
    out: List[Violation] = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.name in ("time", "random"):
                    out.append(Violation(
                        path, n.lineno, "DET001",
                        f"import {a.name} in core/ — the simulation "
                        "substrate must be deterministic (seeded "
                        "np.random.default_rng is the sanctioned rng)"))
        elif isinstance(n, ast.ImportFrom):
            if n.module in ("time", "random"):
                out.append(Violation(
                    path, n.lineno, "DET001",
                    f"from {n.module} import ... in core/ — the "
                    "simulation substrate must be deterministic"))
        elif isinstance(n, ast.Call):
            f = n.func
            if not isinstance(f, ast.Attribute):
                continue
            if f.attr == "default_rng" and not (n.args or n.keywords):
                out.append(Violation(
                    path, n.lineno, "DET003",
                    "unseeded default_rng() in core/ — pass an explicit "
                    "seed"))
            # np.random.<legacy dist>(...) — the unseeded global stream
            if (isinstance(f.value, ast.Attribute)
                    and f.value.attr == "random"
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id in ("np", "numpy")
                    and f.attr != "default_rng"):
                out.append(Violation(
                    path, n.lineno, "DET002",
                    f"legacy np.random.{f.attr}() in core/ — draws from "
                    "the unseeded global stream; use a seeded "
                    "default_rng generator"))
    return out


# -- CNT: BackendRun / QueryResult counter pairing ---------------------------
def _dataclass_fields(tree: ast.AST, cls_name: str) -> Optional[Set[str]]:
    cls = next((n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
                and n.name == cls_name), None)
    if cls is None:
        return None
    return {st.target.id for st in cls.body
            if isinstance(st, ast.AnnAssign)
            and isinstance(st.target, ast.Name)}


def check_counter_pairing(trees: Dict[str, ast.AST]) -> List[Violation]:
    bk_path = next((p for p in trees
                    if _module_key(p) == "api/backends.py"), None)
    rs_path = next((p for p in trees
                    if _module_key(p) == "api/results.py"), None)
    if bk_path is None or rs_path is None:
        return []
    run_fields = _dataclass_fields(trees[bk_path], "BackendRun")
    qr_fields = _dataclass_fields(trees[rs_path], "QueryResult")
    if run_fields is None or qr_fields is None:
        return []
    run_only: Set[str] = set()
    for n in ast.walk(trees[bk_path]):
        if (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "RUN_ONLY_COUNTERS"):
            run_only = _frozenset_literal(n.value) or set()
    out: List[Violation] = []
    for f in sorted(run_fields - qr_fields - run_only
                    - STRUCTURAL_RUN_FIELDS):
        out.append(Violation(
            bk_path, 0, "CNT001",
            f"BackendRun.{f} has no matching QueryResult attribution "
            "field — per-query results silently drop it; add the field "
            "(+ payload summation in collect_results) or declare it in "
            "RUN_ONLY_COUNTERS with a rationale"))
    return out


# -- driver ------------------------------------------------------------------
def lint_paths(paths: Sequence[str]) -> List[Violation]:
    files: List[Path] = []
    for p in paths:
        pth = Path(p)
        if pth.is_dir():
            files.extend(sorted(pth.rglob("*.py")))
        else:
            files.append(pth)
    trees: Dict[str, ast.AST] = {}
    out: List[Violation] = []
    for f in files:
        try:
            trees[str(f)] = ast.parse(f.read_text(), filename=str(f))
        except SyntaxError as e:
            out.append(Violation(str(f), e.lineno or 0, "PARSE", str(e)))
    for fpath, tree in trees.items():
        key = _module_key(fpath)
        out += check_event_literals(tree, key, fpath)
        out += check_fit_rng_order(tree, key, fpath)
        out += check_core_determinism(tree, key, fpath)
    out += check_config_gates(trees)
    out += check_counter_pairing(trees)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(argv if argv is not None else sys.argv[1:]) or ["src"]
    violations = lint_paths(args)
    for v in violations:
        print(v)
    n_files = sum(len(list(Path(p).rglob("*.py")))
                  if Path(p).is_dir() else 1 for p in args)
    if violations:
        print(f"repro_torch.analysis.lint: {len(violations)} violation(s) "
              f"in {n_files} file(s)")
        return 1
    print(f"repro_torch.analysis.lint: OK ({n_files} file(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
