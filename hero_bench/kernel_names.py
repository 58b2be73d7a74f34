"""Profiler kernel names -> the port's kernels.  The port's kernels are
CUDA C++ ``__global__`` functions; a device trace names them by symbol
(the table below, from ``repro_torch.kernels.ops.KERNELS`` and
``BACKWARD_KERNELS`` as the port has them).  Anything else is a cuBLAS
product (``gemm``) or another kernel (``other``: elementwise, reductions,
copies, the optimizer's passes)."""
from __future__ import annotations

# (label, symbols); the backward is matched first, as no forward symbol
# is a prefix of a backward one but the table is read in order
PORT = (
    ("K2-bwd", ("flash_bwd_prep", "flash_bwd_dkdv_wgmma",
                "flash_bwd_dq_wgmma", "flash_bwd_delta", "flash_bwd_dkdv",
                "flash_bwd_dq", "flash_bwd_sum")),
    ("K1", ("decode_attn", "decode_mla_wgmma", "decode_mla_combine",
            "decode_mla")),
    ("K2", ("flash_fwd_wgmma", "flash_combine", "flash_fwd",
            "flash_mla_wgmma", "flash_mla_combine", "flash_mla")),
    ("K3", ("topk_partial", "topk_merge")),
    ("K4", ("int8_mm_wgmma", "int8_mm")),
    ("K5", ("ssd_decode", "ssd_chunk_mma", "ssd_chunk_fwd")),
    ("K5-bwd", ("ssd_bwd_keys_mma", "ssd_bwd_queries_mma", "ssd_bwd_tiles",
                "ssd_bwd_finish")),
)
GEMM = ("gemm", "xmma", "cutlass", "cublas", "gemv", "nvjet")


def label(name: str) -> str:
    """K1 / K2 / K2-bwd / K3 / K4 / K5 / K5-bwd, ``gemm`` or ``other``."""
    for lab, symbols in PORT:
        if any(s in name for s in symbols):
            return lab
    low = name.lower()
    if any(g in low for g in GEMM):
        return "gemm"
    return "other"
