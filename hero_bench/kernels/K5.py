"""K5, the SSD chunk (``repro_torch.kernels.ops.ssd_chunk``,
``csrc/ssd_chunk.cu``): its symbols.  The benchmark does not price
it."""

SYMBOLS = ("ssd_decode", "ssd_chunk_mma", "ssd_chunk_fwd")
