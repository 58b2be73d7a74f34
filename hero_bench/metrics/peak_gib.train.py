"""torch.cuda.max_memory_allocated() over the measured window (reset at
its open, so set-up's copies do not count), in GiB."""

UNIT = "GiB"
SOURCE = "program_counter"
LAYER = "Training"
MOVES = "train_tokens_per_s"


def read(run):
    return run.window_peak / 2**30 if run.window_peak else None
