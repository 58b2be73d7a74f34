"""One minus the union of kernel intervals over the traced window."""
from hero_bench import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "Device"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.idle_share(run)
