"""Build, load and bind the hand-written CUDA kernels.

Each source in ``csrc/`` (one kernel each, plain C interface) is compiled by
its own ``nvcc`` process for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at the repository root, at first use; all
the compilers start together.  A library's file name carries a hash of its
source, every header it includes and the flags, so an edit rebuilds it.
Libraries are loaded with ``ctypes`` with every ``argtypes`` declared; each
entry point returns ``cudaGetLastError()`` and :func:`check` raises on
non-zero.

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
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
F = ctypes.c_float

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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes,
    directly or through another header, in first-seen order."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        todo += [CSRC / inc for inc in _INCLUDE.findall(f.read_text())
                 if (CSRC / inc).is_file()]
    return seen


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sources(name):
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
        print(f"[build] {n}: {took[n]:.1f}s; ptxas per kernel: "
              + " | ".join(ptxas_report(out)), flush=True)
        for ln in out.splitlines():
            if "warning" in ln.lower():
                print(f"[build] {n}: {ln.strip()}", flush=True)
        os.replace(tmp, lib_path(n))   # atomic: readers never see a partial
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def ptxas_report(out: str) -> List[str]:
    """``kernel: registers, shared memory[, spills]`` per kernel from
    ``ptxas -v``."""
    lines, name, spill = [], "?", ""
    for ln in out.splitlines():
        m = (re.search(r"entry function '(\w+)'", ln)
             or re.search(r"Function properties for (\w+)", ln))
        if m:
            name = demangle(m.group(1))
        if re.search(r"\b[1-9]\d* bytes spill", ln):
            spill = ", " + ln.split(":", 1)[-1].strip()
        if "Used" in ln:
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}{spill}")
            spill = ""
    return lines


def demangle(mangled: str) -> str:
    """A kernel's mangled name cut to its name and template arguments:
    ``_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi128EEEv...`` ->
    ``flash_fwd_wgmma<128>``."""
    if not mangled.startswith("_Z"):
        return mangled
    s, names = mangled[3 if mangled.startswith("_ZN") else 2:], []
    while s[:1].isdigit():
        digits = re.match(r"\d+", s).group()
        n = int(digits)
        names.append(s[len(digits):len(digits) + n])
        s = s[len(digits) + n:]
    if not names:
        return mangled
    if not s.startswith("I"):
        return names[-1]
    tpl = s[1:s.find("EE") + 1] if "EE" in s else s[1:]
    args = (["f32"] if tpl.startswith("f") else
            ["bf16"] if "__nv_bfloat16" in tpl else [])
    args += re.findall(r"Li(\d+)E", tpl)
    return f"{names[-1]}<{','.join(args)}>"


def opcode_pattern(op: str) -> "re.Pattern[str]":
    """An opcode and its modifiers, in order, with any others between:
    ``LDG.E.128`` matches ``LDG.E.128.CONSTANT`` and ``LDG.E.EL.128``,
    ``IGMMA`` matches ``IGMMA.64x64x32.S8.S8``."""
    return re.compile(r"\b" + r"(?:\.\w+)*\.".join(
        re.escape(p) for p in op.split(".")) + r"\b")


def sass_counts(name: str, opcodes: Sequence[str]) -> Dict[str, Dict]:
    """{kernel: {opcode: count}} of the built library's machine code
    (``cuobjdump -sass``): shows which instructions a kernel really
    issues, e.g. HGMMA (bf16 wgmma), IGMMA (int8 wgmma), UTMALDG (a TMA
    load), LDGSTS (cp.async), LDG.E.128 (a 16-byte global load),
    UCGABAR_WAIT (a cluster barrier); see :func:`opcode_pattern`."""
    exe = Path(nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(exe), "-sass", str(lib_path(name))],
                         capture_output=True, text=True, check=True).stdout
    pats = {op: opcode_pattern(op) for op in opcodes}
    counts: Dict[str, Dict] = {}
    cur = None
    for ln in out.splitlines():
        m = re.search(r"Function : (\w+)", ln)
        if m:
            cur = counts.setdefault(demangle(m.group(1)),
                                    {op: 0 for op in opcodes})
        elif cur is not None:
            for op, pat in pats.items():
                if pat.search(ln):
                    cur[op] += 1
    return counts


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


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for ctypes, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


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
