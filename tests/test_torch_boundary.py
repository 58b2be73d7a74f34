"""Boundary and drift guards of the PyTorch port.

1. No module of ``src/repro_torch/`` (``training/``, ``checkpoint/`` and
   ``launch/train.py`` included), no torch example
   (``examples/*_torch.py``) and not ``chip_smoke.py`` imports JAX or
   anything of the JAX package ``repro`` (by import statement or by a
   module name in a string, as ``configs.get_family`` uses).
2. Each control-plane module the port copies equals the JAX package's with
   ``repro.`` renamed ``repro_torch.``, so a fix to one cannot silently
   miss the other.
3. With no GPU and no explicit device, the port's entry points raise
   instead of running on the CPU.
"""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

COPIES = sorted(
    [p.relative_to(SRC / "repro")
     for d in ("configs", "core", "api", "analysis")
     for p in (SRC / "repro" / d).glob("*.py")]
    + [pathlib.Path("rag") / f"{m}.py" for m in
       ("tokenizer", "chunker", "datasets", "workflow", "stages")]
    + [pathlib.Path("serving/executor.py")])

FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _port_files():
    return (sorted(PORT.rglob("*.py"))
            + sorted((ROOT / "examples").glob("*_torch.py"))
            + [ROOT / "chip_smoke.py"])


def test_port_files_reach_the_training_modules():
    rel = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"training/optimizer.py", "training/train_loop.py",
            "training/grad_compression.py", "checkpoint/checkpoint.py",
            "launch/train.py"} <= rel
    assert ROOT / "examples" / "train_lm_torch.py" in _port_files()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # importlib targets such as "repro.configs.qwen3_family"
            if node.value.startswith(("repro.", "jax.")):
                bad.append(node.value)
    assert not bad, f"{path} reaches {bad}"


def test_copy_list_is_complete():
    assert len(COPIES) > 30
    for rel in COPIES:
        assert (PORT / rel).is_file(), f"repro_torch/{rel} missing"


@pytest.mark.parametrize("rel", COPIES, ids=str)
def test_control_plane_copy_matches_reference(rel):
    want = (SRC / "repro" / rel).read_text().replace("repro.", "repro_torch.")
    assert (PORT / rel).read_text() == want, (
        f"repro_torch/{rel} drifted from repro/{rel}; re-copy it with "
        f"'repro.' renamed 'repro_torch.'")


def test_get_family_resolves_inside_the_port():
    import sys
    from repro_torch.configs import get_config, get_family
    fam = get_family("qwen3")
    assert type(fam["chat"]).__module__ == "repro_torch.configs.base"
    assert type(get_config("qwen1.5-0.5b")).__module__ == \
        "repro_torch.configs.base"
    assert "repro_torch.configs.qwen3_family" in sys.modules


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.launch.serve import build_pipeline
    from repro_torch.rag import VectorDB
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        build_pipeline()
    with pytest.raises(RuntimeError, match="no GPU"):
        VectorDB(dim=8, capacity=16)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _kernel_table():
    from repro_torch.kernels import ops
    return ops.KERNELS


@pytest.mark.parametrize("kernel", _kernel_table(), ids=lambda k: k.name)
def test_kernel_table_names_real_sources_and_tpu_kernels(kernel):
    """Each row of ``ops.KERNELS`` points at its CUDA source, at every
    ``__global__`` function in it, at the Pallas kernel it ports, and at a
    wrapper module with a launch counter."""
    import re
    src = (ROOT / kernel.source).read_text()
    globals_ = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
        src))
    assert globals_ == set(kernel.symbols)
    path, line = kernel.replaces.rsplit(":", 1)
    jax_line = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert re.match(r"def _\w+_kernel\(", jax_line), jax_line
    assert callable(getattr(kernel.module, kernel.name))
    assert kernel.module.launches.count >= 0


def _backward_table():
    from repro_torch.kernels import ops
    return ops.BACKWARD_KERNELS


@pytest.mark.parametrize("kernel", _backward_table(), ids=lambda k: k.name)
def test_backward_kernel_table_names_real_sources_and_the_autodiff_replaced(
        kernel):
    """Each row of ``ops.BACKWARD_KERNELS`` points at its CUDA source, at
    every ``__global__`` function in it, at the ``KERNELS`` row whose
    gradient it computes, at the JAX function whose XLA autodiff it
    replaces (the JAX package has no backward Pallas kernel), and at a
    wrapper module with a launch counter of its own."""
    import re
    from repro_torch.kernels import ops
    src = (ROOT / kernel.source).read_text()
    globals_ = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
        src))
    assert globals_ == set(kernel.symbols)
    forward = {k.name: k for k in ops.KERNELS}[kernel.differentiates]
    path, line = kernel.autodiff_of.rsplit(":", 1)
    jax_line = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert re.match(r"def \w+\(", jax_line), jax_line
    assert callable(getattr(kernel.module, kernel.name))
    assert kernel.module.launches is not forward.module.launches
    assert kernel.name not in {k.name for k in ops.KERNELS}


def _optimizer_table():
    from repro_torch.kernels import ops
    return ops.OPTIMIZER_KERNELS


@pytest.mark.parametrize("kernel", _optimizer_table(), ids=lambda k: k.name)
def test_optimizer_kernel_table_names_real_sources_and_the_jax_function(
        kernel):
    """Each row of ``ops.OPTIMIZER_KERNELS`` points at its CUDA source, at
    every ``__global__`` function in it, at the JAX function whose XLA
    code it replaces (it ports no TPU kernel), and at a wrapper module
    with a launch counter of its own; no symbol of it is part of another
    table's, so a trace tells them apart."""
    import re
    from repro_torch.kernels import ops
    src = (ROOT / kernel.source).read_text()
    globals_ = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
        src))
    assert globals_ == set(kernel.symbols)
    path, line = kernel.replaces.rsplit(":", 1)
    jax_line = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert re.match(r"def \w+\(", jax_line), jax_line
    assert callable(getattr(kernel.module, kernel.name))
    others = (*ops.KERNELS, *ops.BACKWARD_KERNELS)
    assert kernel.name not in {k.name for k in others}
    assert all(kernel.module.launches is not k.module.launches
               for k in others)
    theirs = {s for k in others for s in k.symbols}
    assert not any(a in b or b in a for a in kernel.symbols for b in theirs)


def test_launch_counts_cover_the_kernel_table():
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    assert ops.launch_counts() == {k.name: 0 for k in ops.KERNELS}
    assert ops.backward_launch_counts() == {
        k.name: 0 for k in ops.BACKWARD_KERNELS}
    assert ops.optimizer_launch_counts() == {
        k.name: 0 for k in ops.OPTIMIZER_KERNELS}


def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu(
        monkeypatch):
    """The meta device (the dry-run) gets the kernel's result shapes and
    never the plain version; any device but the CPU, the card and meta
    raises."""
    import types

    from repro_torch.kernels import ops, ref

    def plain(*a, **kw):
        raise AssertionError("the plain version ran off the CPU")
    monkeypatch.setattr(ref, "decode_attention_ref", plain)
    q = torch.zeros(1, 2, 16, device="meta")
    out = ops.decode_attention(q, q[:, None], q[:, None],
                               torch.ones(1, dtype=torch.int32))
    assert out.is_meta and out.shape == q.shape
    other = types.SimpleNamespace(is_meta=False, is_cuda=False,
                                  device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops._route(other)
