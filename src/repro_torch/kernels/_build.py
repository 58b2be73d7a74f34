"""Build, load and bind the hand-written CUDA kernels.

Each source in ``csrc/`` (one kernel each, plain C interface) is compiled by
its own ``nvcc`` process for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at the repository root, at first use; all
the compilers start together.  A library's file name carries a hash of its
source, the shared header and the flags, so an edit rebuilds it.  Libraries
are loaded with ``ctypes`` with every ``argtypes`` declared; each entry
point returns ``cudaGetLastError()`` and :func:`check` raises on non-zero.

Nothing here runs at import: the CPU tests import every module, and this
machine need have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one right after each launch
    it makes (never for the plain version), so a run can show that the main
    path went through the kernel.  Executor threads share it, hence the
    lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every missing library of ``names`` (``csrc/<name>.cu``) in
    parallel, one nvcc per source.
    Returns {name: seconds} for those it compiled; prints ptxas' register
    and shared-memory report for each."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    took, errors = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        took[n] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        # ptxas -v: registers and shared memory of each kernel, and any
        # non-zero spill
        report = [ln.split(":", 1)[-1].strip() for ln in out.splitlines()
                  if "Used" in ln or re.search(r"\b[1-9]\d* bytes spill", ln)]
        print(f"[build] {n}: {took[n]:.1f}s; ptxas per kernel: "
              + " | ".join(report), flush=True)
        os.replace(tmp, lib_path(n))   # atomic: readers never see a partial
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if missing),
    with ``argtypes``/``restype`` set for each entry point."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, args in signatures.items():
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_cuda(name: str, tensors: List[torch.Tensor]) -> None:
    """Every tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda and t.device == dev,
                f"{name}: all inputs must be on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
