"""Finds the benchmark's pieces by name under its directory ``root``:
``workloads/<cell>.json``, ``configs/<config>.json``,
``metrics/<metric>.py``, a model family's ``families/<family>.py`` and
its plain reference ``reference/<family>.py``, and a kernel's
``kernels/<label>.py``; and reads which metrics a cell reports from
``BENCHMARK.json``.  A later change adds a cell, a configuration, a
family, a kernel or a metric by adding files and entries only."""
from __future__ import annotations

import importlib.util
import json
import sys
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


def _load(path: Path, what: str) -> ModuleType:
    """The module in file ``path``, entered in ``sys.modules`` before it
    runs, as a dataclass defined in it needs."""
    if not path.is_file():
        raise KeyError(f"no {what} {path}")
    ident = path.stem.replace(".", "_").replace("-", "_")
    name = f"hero_bench_{what.replace(' ', '_')}_{ident}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_path(name: str, root: Path = HERE) -> Path:
    return root / "metrics" / f"{name}.py"


def load_metric(name: str, root: Path = HERE) -> ModuleType:
    """The reader of metric ``name``: a module with ``UNIT``, ``SOURCE``
    and ``read(run) -> Optional[float]``."""
    return _load(metric_path(name, root), "metric reader")


def load_family(name: str, root: Path = HERE) -> ModuleType:
    """Model family ``name`` (a configuration file's ``family``): a module
    with ``model_config(conf)`` -> the port's ``ModelConfig``,
    ``init_scale(leaf, shape, conf)`` -> the normal's scale of a leaf (0:
    ones) and ``train_step_flops(conf, batch, seq)``."""
    return _load(root / "families" / f"{name}.py", "family")


def load_reference(name: str, root: Path = HERE) -> ModuleType:
    """The plain reference of family ``name``: a module with
    ``loss_and_grads(conf, W, tokens, precision) -> (loss, {leaf:
    gradient})``."""
    return _load(root / "reference" / f"{name}.py", "reference")


def load_kernels(root: Path = HERE) -> Dict[str, ModuleType]:
    """Every ``kernels/<label>.py`` by label: ``SYMBOLS`` (the names a
    device trace gives its launches) and, where the benchmark prices the
    kernel, ``TARGET`` (the ``repro_torch`` module and the attribute that
    launches it) and ``cost(*args, **kwargs) -> costs.Cost`` of a call."""
    return {p.stem: _load(p, "kernel")
            for p in sorted((root / "kernels").glob("*.py"))}


def benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def metrics_of(cell: str, kind: str, bench: Optional[dict] = None
               ) -> Dict[str, dict]:
    """The ``end_to_end`` or ``per_layer`` entries ``cell`` reports: those
    without a ``workloads`` key and those that list it."""
    bench = bench if bench is not None else benchmark()
    return {m["name"]: m for m in bench[kind]
            if cell in m.get("workloads", [cell])}
