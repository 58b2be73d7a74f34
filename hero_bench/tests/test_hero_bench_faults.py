"""The comparison that decides ``correct`` catches each fault a cell can
have: a tiny run of the cell on the CPU, the harness's look for a chip
skipped, with the timed path broken underneath, must come out not
correct; the same run unbroken comes out correct.  The control (the
reference computed in a lower precision in the program's place) must
read above the program."""
import time

import pytest
import torch

from hero_bench import check
from hero_bench.report import measure
from hero_bench.tests import tiny

SEED = 3_000_000_017        # beyond 32 bits, as the driver's are


def train():
    wl, conf = tiny.train_cell()
    return measure(wl, SEED, 0.5, False, torch.device("cpu"),
                   time.monotonic(), bench=tiny.bench(), conf=conf)[0]


def test_train_sound_run_is_correct():
    res = train()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_train_state_left_unchanged_is_caught(monkeypatch):
    from repro_torch.training import train_loop

    def unchanged(grads, state, params, cfg):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(train_loop, "adamw_update", unchanged)
    res = train()
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_left_out_is_caught(monkeypatch):
    from repro_torch.models import lm
    loss_fn = lm.loss_fn

    def half(params, cfg, batch):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(params, cfg, {k: v[:rows] for k, v in batch.items()})
    monkeypatch.setattr(lm, "loss_fn", half)
    assert not train()["correct"]


def test_train_control_reads_far_above_the_program():
    """At the test's size: the fp8 reference in the program's place
    against the f32 reference, beside the program's own readings."""
    from hero_bench import traffic
    from hero_bench.train import optimizer_args
    wl, conf = tiny.train_cell()
    params, w = tiny.program_model(conf, SEED)
    feed = traffic.train_batches(wl["mix"], SEED, conf["vocab_size"],
                                 torch.device("cpu"))
    batches = [next(feed)["tokens"] for _ in range(3)]
    sample = check.sample_indices({k: p.numel() for k, p in
                                   params.named_parameters()}, SEED)
    got = check.control_train(conf, w, batches, optimizer_args(conf),
                              sample)
    prog = train()["checks"]
    ctl = got["control"]
    assert ctl["first_grad_err_median"] > \
        3 * prog["first_grad_err_median"]["value"]
    assert not check.verdict(ctl, wl["limits"])
    assert not check.verdict(got["fault_half_batch"], wl["limits"])
