"""Tokens of every optimizer step completed in the window (the step in
progress at the close by the share of it done, from CUDA events) over
the window."""
from hero_bench.stats import rate
from hero_bench.train import completed_steps

UNIT = "tokens/s"
SOURCE = "host_clock"
LAYER = "End to end"
MOVES = "train_tokens_per_s"


def read(run):
    if not run.step_ends:
        return None
    return rate(completed_steps(run.step_ends, run.seconds)
                * run.tokens_per_step, run.seconds)
