"""Device ms a step of the kernels launched inside the program's
``train.forward`` span (the loss), over the complete steps of the traced
window."""
from hero_bench import readers

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Training"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.span_ms_per_step(run, "repro_torch.train.forward")
