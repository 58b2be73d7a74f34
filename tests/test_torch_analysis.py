"""``repro_torch.analysis``, the copy of ``repro.analysis``: spec
validation behind ``WorkflowSpec.build_dag(validate=True)`` and
``SessionOptions(validate_spec=True)`` behaves as the reference's (the
ports of ``tests/test_analysis_validate.py``'s two wiring tests, on the
same fixture), and the lint finds in the port's tree what it finds in the
reference's.

The lint's ``_module_key`` locates a module by the last ``repro/`` in its
path, so on a path under ``src/repro_torch/`` it returns only the file
name and the ``core/``-scoped rules (DET) never fire.  The copy stays
verbatim; the lint test therefore lints a copy of the port's tree placed
in a directory named ``repro``, where the key resolves, and shows that a
DET rule fires there.
"""
import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis.lint import lint_paths as j_lint  # noqa: E402
from repro.api.spec import builtin_spec as j_builtin_spec  # noqa: E402
from repro.rag import sample_traces as j_sample_traces  # noqa: E402
from repro_torch.analysis.lint import lint_paths  # noqa: E402
from repro_torch.analysis.validate import SpecValidationError  # noqa: E402
from repro_torch.api.options import SessionOptions  # noqa: E402
from repro_torch.api.spec import builtin_spec  # noqa: E402
from repro_torch.rag import sample_traces  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def trace():
    return sample_traces("hotpotqa", 1, seed=11)[0]


@pytest.mark.parametrize("wf", [1, 2, 3])
def test_build_dag_validate_kwarg(trace, wf):
    dag = builtin_spec(wf).build_dag(trace, validate=True)
    assert dag.nodes
    want = j_builtin_spec(wf).build_dag(
        j_sample_traces("hotpotqa", 1, seed=11)[0], validate=True)
    assert sorted(dag.nodes) == sorted(want.nodes)
    if wf == 1:
        assert len(dag.nodes) == 6


def test_session_option_runs_validation(trace):
    from repro_torch.api import HeroSession
    sess = HeroSession(world="sd8gen4", family="qwen3",
                       options=SessionOptions(validate_spec=True))
    sess.submit(trace, wf=1)
    [res] = sess.run()
    assert res.makespan > 0


def test_validation_rejects_a_broken_spec_as_the_reference_does(trace):
    from repro_torch.api.spec import StageSpec, WorkflowSpec
    s = StageSpec(id="a", stage="embed", kind="batchable", workload=8,
                  deps=("missing",))
    spec = WorkflowSpec(name="t", statics=(s,), groups=(), collector=None)
    with pytest.raises(SpecValidationError, match="S002"):
        spec.build_dag(trace, validate=True)


def test_lint_of_the_port_tree_matches_the_reference(tmp_path):
    root = tmp_path / "src" / "repro"
    shutil.copytree(SRC / "repro_torch", root,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    want = [(Path(v.path).relative_to(SRC / "repro").as_posix(), v.rule)
            for v in j_lint([str(SRC / "repro")])]
    got = [(Path(v.path).relative_to(root).as_posix(), v.rule)
           for v in lint_paths([str(root)])]
    assert got == want
    # the key resolves in the copy: a core/ module that imports `time`
    # trips DET001
    sim = root / "core" / "simulator.py"
    sim.write_text("import time\n" + sim.read_text())
    assert [v.rule for v in lint_paths([str(sim)])] == ["DET001"]
