"""Device ms a step of the kernels launched inside the program's
``train.backward`` span (``torch.autograd.grad``; most from autograd's
device thread), over the complete steps of the traced window."""
from hero_bench import readers

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Training"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.span_ms_per_step(run, "repro_torch.train.backward")
