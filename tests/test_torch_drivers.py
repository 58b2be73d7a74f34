"""The port's main-path drivers on the CPU: ``examples/document_qa_torch.py``
(W2 for two finqabench traces through the port's stage fns, reduced f32
models) and the kernel bench's table (``launch/kernels_bench.py``, whose
timing ``chip_smoke.py`` imports instead of keeping a copy)."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import kernels_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_document_qa_torch_finishes_both_queries_on_the_cpu(capsys):
    example = _load(ROOT / "examples" / "document_qa_torch.py",
                    "document_qa_torch")
    results, done = example.main(["--device", "cpu"])
    assert len(results) == 2
    assert all(r.n_nodes > 0 and r.makespan > 0 for r in results)
    # every node of both queries completed once, streamed to the caller
    assert len(done) == sum(r.n_nodes for r in results)
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == (f"{len(done)} stage completions streamed via "
                       f"on_stage_done")
    assert [line.split(":")[0] for line in out[-3:-1]] == ["query 0",
                                                            "query 1"]


def test_bench_rows_cover_every_kernel_and_backward_kernel():
    names = {n for keys in kernels_bench.PATH_KEYS.values() for n in keys}
    want = {k.name for k in (*ops.KERNELS, *ops.BACKWARD_KERNELS)}
    assert want <= names, want - names
    assert names <= set(kernels_bench.REPLAY)
    assert kernels_bench.COLUMNS.split(",") == [
        "name", "path", "device_us", "host_us", "bound_us", "bound_by",
        "plain_us", "library_us"]


def test_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        kernels_bench.run(csv=lambda line: None)


def test_chip_smoke_takes_its_timing_and_cases_from_the_bench():
    smoke = _load(ROOT / "chip_smoke.py", "chip_smoke_for_drivers")
    for name in ("timed", "bound_ms", "measure", "REPLAY", "flash_case",
                 "BWD_TOL"):
        assert getattr(smoke, name) is getattr(kernels_bench, name), name
    from repro_torch.launch import h100
    assert kernels_bench.PEAK_FLOPS is h100.PEAK_FLOPS
    assert kernels_bench.HBM_BYTES_PER_S == h100.HBM_BYTES_PER_S == 3.35e12
