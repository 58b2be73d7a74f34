"""Model FLOPs of the steps completed in the traced window (6 per active
parameter a token, attention three times its forward, recompute not
counted) over the window at 989 TFLOP/s."""
from hero_bench import readers

UNIT = "%"
SOURCE = "device_trace"
LAYER = "Whole program"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.train_mfu(run)
