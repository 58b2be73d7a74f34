"""Host ms a step inside the program's ``train.optimizer`` span, under
the profiler, which adds its own cost to each operator it records, over
the complete steps of the traced window."""
from hero_bench import readers

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Training"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.span_host_ms_per_step(run, "repro_torch.train.optimizer")
