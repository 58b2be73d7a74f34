"""K2, flash attention (``repro_torch.kernels.ops.flash_attention``,
``csrc/flash_attention.cu``): its symbols, and the cost of each call
from its shapes (``costs.k2_forward``; the f32 LSE where a gradient
will be taken, as the training forward writes it)."""
from hero_bench import costs

SYMBOLS = ("flash_fwd_wgmma", "flash_combine", "flash_fwd",
           "flash_mla_wgmma", "flash_mla_combine", "flash_mla")
TARGET = ("repro_torch.kernels.ops", "flash_attention")


def cost(q, k, v, *, causal=True, q_offset=0, kv_len=None,
         kv_positions=None, window=0, scale=None) -> costs.Cost:
    b, sq, h, e = q.shape
    n, ev = k.shape[2], v.shape[-1]
    size, dt = costs.itemsize_and_type(q)
    return costs.k2_forward(
        b, sq, h, n, e, ev, k.shape[1] if kv_len is None else kv_len,
        causal, q_offset, size, dt, lse=q.requires_grad or k.requires_grad)
