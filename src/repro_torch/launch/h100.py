"""The NVIDIA H100's datasheet rates (SXM part, dense, at its 700 W power
limit): the one place ``chip_smoke.py``, the kernel bench
(``launch/kernels_bench.py``) and the dry-run (``launch/dryrun.py``) take
them from.  A card set below 700 W runs slower than these under load, so
every time measured against them is reported beside the card's power
limit."""
from __future__ import annotations

import torch

HBM_BYTES = 80e9                 # device memory
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9       # NVLink 4, one direction, per GPU
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor cores
              torch.float32: 67e12,           # f32 outside the tensor cores
              torch.int8: 1979e12,            # int8 tensor cores (TOP/s)
              # f32 accuracy on the TF32 tensor cores (495 TFLOP/s) by
              # three products of split operands, as K5's ssd_chunk_mma,
              # or by two where the other operand is bf16 (exact in TF32)
              "tf32x3": 495e12 / 3, "tf32x2": 495e12 / 2}
