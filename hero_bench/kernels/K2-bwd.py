"""K2's backward (``repro_torch.kernels.flash_attention_bwd``,
``csrc/flash_attention_bwd.cu``): its symbols, and the cost of each call
from its shapes (``costs.k2_backward``)."""
from hero_bench import costs

SYMBOLS = ("flash_bwd_prep", "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma",
           "flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq",
           "flash_bwd_sum")
TARGET = ("repro_torch.kernels.flash_attention_bwd", "flash_attention_bwd")


def cost(q, k, v, *args, **kwargs) -> costs.Cost:
    b, sq, h, e = q.shape
    size, dt = costs.itemsize_and_type(q)
    return costs.k2_backward(
        b, sq, h, k.shape[2], e, v.shape[-1],
        kwargs.get("kv_len") or k.shape[1], kwargs.get("causal", True),
        kwargs.get("q_offset", 0), size, dt)
