"""Kernel launches a step (the runtime's ``cudaLaunch*`` and
``cuLaunch*`` events inside the program's ``train.step`` span), over
the complete steps of the traced window."""
from hero_bench import readers

UNIT = "launches"
SOURCE = "device_trace"
LAYER = "Training"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.launches_per_step(run)
