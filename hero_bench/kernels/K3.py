"""K3, top-k retrieval (``repro_torch.kernels.ops.topk_retrieval``,
``csrc/topk_retrieval.cu``): its symbols.  The benchmark does not price
it."""

SYMBOLS = ("topk_partial", "topk_merge")
