"""Device ms a step in kernels that are neither cuBLAS products nor the
port's own (the optimizer's passes, elementwise, copies)."""
from hero_bench import readers

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Training"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.other_kernels_ms_per_step(run)
