"""Device ms a step of the kernels launched inside the program's
``lm.block`` spans that lie inside ``train.backward``: the blocks remat
recomputes, over the complete steps of the traced window."""
from hero_bench import readers

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Training"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.span_ms_per_step(run, "repro_torch.lm.block",
                                   within="repro_torch.train.backward")
