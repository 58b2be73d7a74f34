"""Device ms a step of the kernels launched inside the program's
``moe.experts`` spans (``models/moe.py`` ``moe_ffn_dropless``: the
grouped products of the held experts and their SiLU times up), in the
forward and again in remat's recompute inside ``train.backward``, over
the complete steps of the traced window. The backward of these
operations is launched by autograd outside the spans and is not counted."""
from hero_bench import readers

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Expert layer"
MOVES = "train_tokens_per_s"


def read(run):
    return readers.span_ms_per_step(run, "repro_torch.moe.experts")
