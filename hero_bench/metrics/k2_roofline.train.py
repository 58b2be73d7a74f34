"""K2 forward and backward together, as k2_roofline.w1."""
from hero_bench import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "Kernels"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.kernel_roofline(run, ("K2", "K2-bwd"))
