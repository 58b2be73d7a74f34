"""Process start to the window's open: weights drawn on the device, kernels
loaded from the build cache, the cell's shapes warmed up (a train
cell's first three steps, which the reference follows)."""

UNIT = "s"
SOURCE = "host_clock"
LAYER = "End to end"
MOVES = "setup_s"


def read(run):
    return run.setup_s
