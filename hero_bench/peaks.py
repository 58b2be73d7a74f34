"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12        # tensor cores, bf16 and fp16
F32_FLOPS = 67e12          # CUDA cores, float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def flops_peak(dtype_name: str) -> float:
    """Peak rate for a kernel's arithmetic type."""
    return F32_FLOPS if dtype_name == "float32" else BF16_FLOPS
