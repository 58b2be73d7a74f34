"""K1, decode attention (``repro_torch.kernels.ops.decode_attention``,
``csrc/decode_attention.cu``): its symbols.  The benchmark does not
price it."""

SYMBOLS = ("decode_attn", "decode_mla_wgmma", "decode_mla_combine",
           "decode_mla")
