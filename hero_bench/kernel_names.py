"""Profiler kernel names -> the port's kernels.  The port's kernels are
CUDA C++ ``__global__`` functions; a device trace names them by symbol,
and each kernel's file ``kernels/<label>.py`` lists its ``SYMBOLS`` (from
``repro_torch.kernels.ops.KERNELS`` and ``BACKWARD_KERNELS`` as the port
has them).  Anything else is a cuBLAS product (``gemm``) or another
kernel (``other``: elementwise, reductions, copies, the optimizer's
passes)."""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Tuple

from hero_bench import registry

GEMM = ("gemm", "xmma", "cutlass", "cublas", "gemv", "nvjet")


@functools.lru_cache(maxsize=None)
def table(root: Path = registry.HERE
          ) -> Tuple[Tuple[str, Tuple[str, ...]], ...]:
    """(label, symbols) of every kernel file, the backward labels
    (``-bwd``) first: a name is given the first label one of whose
    symbols it contains."""
    files = registry.load_kernels(root)
    order = sorted(files, key=lambda lab: (not lab.endswith("-bwd"), lab))
    return tuple((lab, tuple(files[lab].SYMBOLS)) for lab in order)


def label(name: str, root: Path = registry.HERE) -> str:
    """A kernel file's label (K1, K2, K2-bwd, ...), ``gemm`` or
    ``other``."""
    for lab, symbols in table(root):
        if any(s in name for s in symbols):
            return lab
    low = name.lower()
    if any(g in low for g in GEMM):
        return "gemm"
    return "other"
