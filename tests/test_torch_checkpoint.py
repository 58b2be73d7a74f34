"""The port's ``Checkpointer`` (``repro_torch.checkpoint``): what the JAX
version gets from immutable arrays and ml_dtypes, the port must do itself.

A bf16 model and its bf16 AdamW moments round-trip bit-exact (numpy has no
bfloat16: the leaves are stored as raw 16 bits); saves run on a thread and
keep the newest ``keep``; only ``manifest.json`` names the latest step, so
a write cut short is never restored; a run restarts from the latest step;
and the snapshot taken at ``save`` is a copy, so a step that updates the
parameters in place while the thread writes does not reach the file.
"""
import dataclasses
import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckmod  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.training import TrainConfig, make_train_step, train  # noqa: E402

CPU = torch.device("cpu")


def _bf16_model(seed):
    cfg = reduced(get_config("qwen1.5-0.5b"))
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    return cfg, build_model(cfg, CPU).init(seed, trainable=True)


def _noisy_state(params, seed):
    state = adamw_init(params, AdamWConfig(state_dtype="bfloat16"))
    g = torch.Generator().manual_seed(seed)
    for t in (*state.m.values(), *state.v.values()):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return state._replace(step=torch.tensor(7, dtype=torch.int32))


def test_bf16_round_trip_is_bit_exact(tmp_path):
    cfg, params = _bf16_model(0)
    assert {p.dtype for p in params.parameters()} >= {torch.bfloat16}
    state = _noisy_state(params, 1)
    ck = Checkpointer(str(tmp_path))
    ck.save((params, state), 5, block=True)
    _, other = _bf16_model(2)
    (rp, rs), step = ck.restore_latest((other, _noisy_state(other, 3)))
    assert step == 5 and rp is other and int(rs.step) == 7
    assert rs.step.dtype == torch.int32
    for a, b in zip(params.parameters(), rp.parameters()):
        assert a.dtype == b.dtype and b.requires_grad
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    for name in state.m:
        for want, got in ((state.m, rs.m), (state.v, rs.v)):
            assert got[name].dtype == torch.bfloat16
            assert torch.equal(want[name].view(torch.int16),
                               got[name].view(torch.int16))


def test_async_saves_keep_the_newest(tmp_path):
    _, params = _bf16_model(0)
    ck = Checkpointer(str(tmp_path), keep=1)
    for s in (2, 4, 6):
        ck.save(params, s)              # each save waits for the last
    ck.wait()
    assert ck.available_steps() == [6] and ck.latest_step() == 6
    assert sorted(os.listdir(tmp_path)) == ["manifest.json",
                                            "step_00000006.npz"]


def test_manifest_is_the_only_source_of_the_latest_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    ck.save(tree, 3, block=True)
    # a later write torn before its rename and its manifest update
    (tmp_path / "step_00000009.npz.tmp").write_bytes(b"partial")
    (tmp_path / "step_00000011.npz").write_bytes(b"garbage")
    assert ck.latest_step() == 3
    restored, step = ck.restore_latest({"w": torch.zeros(2, 3)})
    assert step == 3 and torch.equal(restored["w"], tree["w"])
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f) == {"latest_step": 3}
    assert Checkpointer(str(tmp_path / "empty")).restore_latest(tree) is None


def test_a_write_error_surfaces_in_wait(tmp_path, monkeypatch):
    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckmod.np, "savez", fail)
    ck = Checkpointer(str(tmp_path))
    ck.save({"w": torch.ones(2)}, 1)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.latest_step() is None


def test_restart_from_latest_continues_the_run(tmp_path):
    """8 steps with a save every 4, then a restart to 12 from step 8: the
    same losses as 12 uninterrupted steps on the same fixed batch."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    batch["labels"] = batch["tokens"]

    def data():
        while True:
            yield batch
    _, _, whole = train(cfg, data(), steps=12, tcfg=tcfg, log_every=1,
                        device=CPU)
    ck = Checkpointer(str(tmp_path))
    train(cfg, data(), steps=8, tcfg=tcfg, checkpointer=ck,
          checkpoint_every=4, device=CPU)
    assert ck.available_steps() == [4, 8]
    _, _, rest = train(cfg, data(), steps=12, tcfg=tcfg, checkpointer=ck,
                       restore=True, log_every=1, device=CPU)
    assert [h["step"] for h in rest] == [8, 9, 10, 11]
    np.testing.assert_allclose([h["loss"] for h in rest],
                               [h["loss"] for h in whole[8:]], rtol=1e-6)


def test_snapshot_does_not_alias_parameters_updated_in_place(
        tmp_path, monkeypatch):
    """The thread writes only after a train step has updated the
    parameters in place: the file must hold the values at save time."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    init, step = make_train_step(cfg, TrainConfig(), CPU)
    params, state = init(0)
    before = [p.detach().clone() for p in params.parameters()]
    stepped = threading.Event()
    savez = ckmod.np.savez

    def late_savez(*a, **k):
        assert stepped.wait(timeout=60)
        return savez(*a, **k)
    monkeypatch.setattr(ckmod.np, "savez", late_savez)
    ck = Checkpointer(str(tmp_path))
    ck.save((params, state), 1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16))
    params, state, _ = step(params, state, {"tokens": toks, "labels": toks})
    assert not all(torch.equal(a, b)
                   for a, b in zip(before, params.parameters()))
    stepped.set()
    ck.wait()
    fresh, fresh_state = init(1)
    (restored, rstate), _ = ck.restore_latest((fresh, fresh_state))
    for a, b in zip(before, restored.parameters()):
        assert torch.equal(a, b)
    assert int(rstate.step) == 0
