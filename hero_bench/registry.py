"""Finds the benchmark's pieces by name: ``workloads/<cell>.json``,
``configs/<config>.json`` and ``metrics/<metric>.py``, and reads which
metrics a cell reports from ``BENCHMARK.json``.  A later change adds a
cell, a configuration or a metric by adding files and entries only."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def workload_names(root: Path = HERE) -> List[str]:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def load_workload(name: str, root: Path = HERE) -> dict:
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no workload {name!r}; have {workload_names(root)}")
    wl = json.loads(path.read_text())
    wl["name"] = name
    for key in ("config", "traffic", "chips", "why", "mix", "limits"):
        if key not in wl:
            raise ValueError(f"workload {name}: no {key!r}")
    return wl


def load_config(name: str, root: Path = HERE) -> dict:
    path = root / "configs" / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no configuration {name!r}")
    return json.loads(path.read_text())


def metric_path(name: str, root: Path = HERE) -> Path:
    return root / "metrics" / f"{name}.py"


def load_metric(name: str, root: Path = HERE) -> ModuleType:
    """The reader of metric ``name``: a module with ``UNIT``, ``SOURCE``
    and ``read(run) -> Optional[float]``."""
    path = metric_path(name, root)
    if not path.is_file():
        raise KeyError(f"no metric reader {path}")
    spec = importlib.util.spec_from_file_location(
        "hero_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def metrics_of(cell: str, kind: str, bench: Optional[dict] = None
               ) -> Dict[str, dict]:
    """The ``end_to_end`` or ``per_layer`` entries ``cell`` reports: those
    without a ``workloads`` key and those that list it."""
    bench = bench if bench is not None else benchmark()
    return {m["name"]: m for m in bench[kind]
            if cell in m.get("workloads", [cell])}
