"""The one traffic generator: it reads a cell's ``mix`` (a data file of
parameters) and makes the batches of a run from the seed."""
from __future__ import annotations


def train_batches(mix: dict, seed: int, vocab: int, device):
    """Batches of ``mix["batch"] x mix["seq"]`` uniform tokens in
    [4, vocab), labels = tokens; batch ``i`` from a generator on
    ``device`` seeded (seed, i), so every row differs and every seed
    offers batches of the same size."""
    import torch
    b, s = mix["batch"], mix["seq"]
    step = 0
    while True:
        g = torch.Generator(device=device).manual_seed(
            (seed * 1_000_003 + step) % (2 ** 63))
        toks = torch.randint(4, vocab, (b, s), generator=g, device=device)
        yield {"tokens": toks, "labels": toks}
        step += 1


def trace_span(mix: dict, seconds: float) -> float:
    """Seconds of the window the traced run profiles."""
    return min(float(mix.get("trace_s", seconds)), seconds)
