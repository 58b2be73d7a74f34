"""K4, the int8 product (``repro_torch.kernels.ops.int8_matmul``,
``csrc/int8_matmul.cu``): its symbols.  The benchmark does not price
it."""

SYMBOLS = ("int8_mm_wgmma", "int8_mm")
