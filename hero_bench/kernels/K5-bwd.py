"""K5's backward (``repro_torch.kernels.ssd_chunk_bwd``,
``csrc/ssd_chunk_bwd.cu``): its symbols.  The benchmark does not price
it."""

SYMBOLS = ("ssd_bwd_keys_mma", "ssd_bwd_queries_mma", "ssd_bwd_tiles",
           "ssd_bwd_finish")
