"""The busiest held expert's rows over the mean held expert's rows, in
the expert layer where that ratio is largest: the program's device-side
count of the rows each held expert took (``models/moe.py``
``EXPERT_ROWS``, by layer, added to in every forward and not in remat's
recompute), summed over every step of the run (the harness cannot reset
it at the window's open) and read once after the window.  1.0 is
perfectly even; None where the program keeps no such count."""
import sys

UNIT = "ratio"
SOURCE = "program_counter"
LAYER = "Expert layer"
MOVES = "train_tokens_per_s"


def read(run):
    moe = sys.modules.get("repro_torch.models.moe")
    rows = getattr(moe, "EXPERT_ROWS", None)
    if rows is None:
        return None
    worst = None
    for counts in rows.read().values():
        mean = sum(counts) / len(counts)
        if mean > 0:
            ratio = max(counts) / mean
            worst = ratio if worst is None else max(worst, ratio)
    return worst
