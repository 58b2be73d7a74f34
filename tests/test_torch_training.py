"""Training of the PyTorch port against the JAX package: the loss and its
gradients, AdamW, gradient accumulation, the train step, remat, the int8
all-reduce and the checkpointed driver.

The first seven tests port ``tests/test_training.py`` one by one (its
``test_grad_accum_equivalence`` at a size that needs no ``slow`` mark);
the rest hold the port to ``repro`` on bridged weights from the same seed,
in f32: the loss within 1e-5 relative and every gradient leaf within
2e-5 + 1e-4·|want| of ``jax.value_and_grad(lm.loss_fn)`` for one reduced
config of each family (deepseek-v3 with its MTP head, zamba2 with a
group so its shared block is in the graph, vlm and audio with a seeded
source and xgate 0.5 so cross-attention is too); ``adamw_update`` within
1e-6; a 3-step loss trajectory within 1e-4.  Remat changes no value.
On the CPU every kernel is its plain version; the guard that stops a
kernel without a backward on the card is checked with the card route
monkeypatched.
"""
import dataclasses
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import train_loop as j_loop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model, lm  # noqa: E402
from repro_torch.training import (AdamWConfig, TrainConfig,  # noqa: E402
                                  adamw_init, adamw_update, compressed_psum,
                                  make_train_step, train)
from repro_torch.training import optimizer as t_opt  # noqa: E402
from repro_torch.training.train_loop import value_and_grad  # noqa: E402

CPU = torch.device("cpu")


def _data(cfg, B=4, S=32):
    k = 0
    while True:
        k += 1
        g = torch.Generator().manual_seed(k)
        t = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
        yield {"tokens": t, "labels": t}


# ---------------------------------------------------------------------------
# tests/test_training.py, ported
# ---------------------------------------------------------------------------

def test_loss_decreases_on_fixed_batch():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    init, step = make_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=1)), CPU)
    params, opt = init(0)
    batch = next(_data(cfg))
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_grad_accum_equivalence():
    cfg = reduced(get_config("granite-3-2b"))
    batch = next(_data(cfg, B=4, S=16))
    outs = []
    for accum in (1, 2, 4):
        init, step = make_train_step(cfg, TrainConfig(grad_accum=accum),
                                     CPU)
        params, opt = init(0)
        p1, _, m = step(params, opt, batch)
        assert (m.keys() >= {"ce", "aux"}) == (accum == 1)
        outs.append(np.concatenate(
            [p.detach().numpy().ravel() for p in p1.parameters()][:5]))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-5)


def test_adamw_state_dtype_halves_memory():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    params = build_model(cfg, CPU).init(0)
    s32 = adamw_init(params, AdamWConfig(state_dtype="float32"))
    s16 = adamw_init(params, AdamWConfig(state_dtype="bfloat16"))
    b32 = sum(x.numel() * x.element_size() for x in s32.m.values())
    b16 = sum(x.numel() * x.element_size() for x in s16.m.values())
    assert b16 * 2 == b32


def test_compressed_psum_single_device():
    """Compression round trip over a one-rank gloo group."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        store = dist.FileStore(os.path.join(d, "store"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
            out = compressed_psum(x)
        finally:
            dist.destroy_process_group()
    # single participant: quantize->dequantize error only
    rel = float((out - x).abs().max() / x.abs().max())
    assert rel < 0.02
    assert out.dtype == x.dtype and out.shape == x.shape


def test_checkpoint_roundtrip_and_gc():
    cfg = reduced(get_config("xlstm-350m"))
    params = build_model(cfg, CPU).init(0)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for s in (1, 2, 3, 4):
            ck.save(params, s, block=True)
        assert ck.available_steps() == [3, 4]       # gc keeps newest 2
        assert ck.latest_step() == 4
        template = build_model(cfg, CPU).init(1)
        restored, step = ck.restore_latest(template)
        assert step == 4
        for a, b in zip(params.parameters(), restored.parameters()):
            assert torch.equal(a, b)


def test_restart_from_latest_after_crash():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        train(cfg, _data(cfg), steps=4, checkpointer=ck, checkpoint_every=2,
              device=CPU)
        # simulate crash + restart: resumes from step 4
        _, _, hist = train(cfg, _data(cfg), steps=6, checkpointer=ck,
                           checkpoint_every=10, restore=True, log_every=1,
                           device=CPU)
        assert hist[0]["step"] == 4


def test_manifest_ignores_partial_writes():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        tree = {"w": torch.ones((4, 4))}
        ck.save(tree, 1, block=True)
        # a torn write (no manifest update) must not be visible
        with open(os.path.join(d, "step_00000099.npz"), "wb") as f:
            f.write(b"garbage")
        assert ck.latest_step() == 1
        restored, step = ck.restore_latest(tree)
        assert step == 1


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

# (arch, layers): one reduced f32 config of each family
FAMILIES = [("qwen1.5-0.5b", None), ("zamba2-1.2b", 7),
            ("llama-3.2-vision-90b", None), ("whisper-large-v3", None),
            ("deepseek-v3-671b", None), ("xlstm-350m", None)]


def _cfgs(arch, layers=None, **changes):
    kw = {} if layers is None else {"layers": layers}
    return (dataclasses.replace(j_reduced(j_get_config(arch), **kw),
                                **changes),
            dataclasses.replace(reduced(get_config(arch), **kw), **changes))


def _jax_params(jcfg, seed=0):
    """The reference's weights as numpy, every cross block's xgate at 0.5
    (0 at init, which would leave cross-attention out of the graph)."""
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(
        jax.random.PRNGKey(seed)))

    def gate(path, x):
        return (np.full_like(x, 0.5) if "xgate" in jax.tree_util.keystr(path)
                else x)
    return jax.tree_util.tree_map_with_path(gate, tree)


def _batch(cfg, b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.vlm.enabled:
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vlm.vision_tokens, cfg.vlm.vision_dim)).astype(np.float32)
    if cfg.encdec.enabled:
        batch["audio_frames"] = rng.standard_normal(
            (b, cfg.encdec.source_positions, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v) for k, v in batch.items()})


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,layers", FAMILIES,
                         ids=[a for a, _ in FAMILIES])
def test_loss_and_grads_match_jax_value_and_grad(arch, layers):
    jcfg, tcfg = _cfgs(arch, layers)
    tree = _jax_params(jcfg)
    jbatch, tbatch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: j_lm.loss_fn(p, jcfg, jbatch), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    params = bridge.params_to_torch(tree, tcfg, CPU, trainable=True)
    (tloss, tmet), tgrads = value_and_grad(
        lambda p, b: lm.loss_fn(p, tcfg, b), params, tbatch)
    assert set(tmet) == set(jmet)
    assert tcfg.mtp_depth == 0 or "mtp_ce" in tmet
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = _leaves(jgrads)
    got = _leaves(bridge.grads_from_torch(params, tgrads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=1e-4,
                                   err_msg=f"{arch} gradient {k}")
    assert any(np.abs(w).max() > 0 for w in want.values())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(state_dtype):
    jcfg, tcfg = _cfgs("qwen1.5-0.5b")
    tree = _jax_params(jcfg)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=20,
                state_dtype=state_dtype)
    jstate = j_opt.adamw_init(jax.tree.map(jnp.asarray, tree),
                              j_opt.AdamWConfig(**ocfg))
    jstate = jstate._replace(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda x: (x + 0.01).astype(x.dtype), jstate.m),
        v=jax.tree.map(lambda x: (x + 1e-4).astype(x.dtype), jstate.v))
    jp, js, jm = j_opt.adamw_update(jax.tree.map(jnp.asarray, grads),
                                    jstate, jax.tree.map(jnp.asarray, tree),
                                    j_opt.AdamWConfig(**ocfg))
    params = bridge.params_to_torch(tree, tcfg, CPU, trainable=True)
    tstate = bridge.adamw_state_to_torch(
        jax.tree.map(np.asarray, tuple(jstate)), tcfg, CPU)
    tgrads = {k: g.detach() for k, g in bridge.params_to_torch(
        grads, tcfg, CPU).named_parameters()}
    tp, ts, tm = adamw_update(tgrads, tstate, params,
                              t_opt.AdamWConfig(**ocfg))
    assert int(ts.step) == int(js.step) == 4
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    step, m, v = bridge.adamw_state_from_torch(ts, tp)
    for want, got in ((jp, bridge.params_from_torch(tp)), (js.m, m),
                      (js.v, v)):
        w, g = _leaves(want), _leaves(got)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, err_msg=k)


def _bf16_leaves(device, shapes=((512, 256), (256,), (1000, 3))):
    """A module of bf16 leaves, its bf16 gradients and f32 AdamW state."""
    params = torch.nn.ParameterDict({
        f"w{i}": torch.nn.Parameter(torch.zeros(s, dtype=torch.bfloat16,
                                                device=device))
        for i, s in enumerate(shapes)})
    grads = {k: torch.ones_like(p) for k, p in params.named_parameters()}
    return params, grads, adamw_init(params, AdamWConfig())


def test_adamw_on_meta_is_one_kernel_call_of_24_bytes_a_parameter():
    """On meta, AdamW is one ``adamw`` operation of the kernel's bytes (p,
    m, v read and written, g read twice: 24 bytes a parameter at bf16
    parameters and gradients and f32 moments) and FLOPs, and allocates
    nothing but the 0-d norm; the whole ``adamw_update`` adds only the
    schedule's scalars."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.launch.op_cost import OpCounter
    params, grads, state = _bf16_leaves("meta")
    named = list(params.named_parameters())
    n = sum(p.numel() for _, p in named)
    sched = [torch.ones((), device="meta") for _ in range(3)]
    with OpCounter() as c:
        gnorm = ops.adamw([p for _, p in named],
                          [grads[k] for k, _ in named],
                          [state.m[k] for k, _ in named],
                          [state.v[k] for k, _ in named], *sched, b1=0.9,
                          b2=0.95, eps=1e-8, weight_decay=0.1,
                          grad_clip=1.0, norm_floor=1e-9)
    assert gnorm.is_meta and gnorm.shape == ()
    assert dict(c.kernels) == {"adamw": 1}
    assert c.bytes == 24 * n
    assert c.flops == c.kernel_flops == kadamw.FLOPS_PER_ELEMENT * n
    assert c.peak_bytes == 4
    with OpCounter() as c:
        _, new, out = adamw_update(grads, state, params, AdamWConfig())
    assert dict(c.kernels) == {"adamw": 1}
    assert c.peak_bytes < 256 < 2 * n
    assert new.step.is_meta and out["grad_norm"].is_meta


def test_adamw_update_on_the_cpu_runs_no_kernel():
    """The CPU runs the plain per-leaf loop: no launch of the kernel pair,
    and the kernel refuses CPU tensors."""
    params, grads, state = _bf16_leaves(CPU)
    ops.reset_launch_counts()
    _, new, out = adamw_update(grads, state, params, AdamWConfig())
    assert ops.optimizer_launch_counts() == {"adamw": 0}
    assert int(new.step) == 1 and float(out["grad_norm"]) > 0
    named = list(params.named_parameters())
    with pytest.raises(ValueError, match="CUDA device"):
        ops.adamw([p for _, p in named], [grads[k] for k, _ in named],
                  [new.m[k] for k, _ in named], [new.v[k] for k, _ in named],
                  *(torch.ones(()) for _ in range(3)), b1=0.9, b2=0.95,
                  eps=1e-8, weight_decay=0.1, grad_clip=1.0, norm_floor=1e-9)


@pytest.mark.parametrize("ptype,gtype,stype,code,nbytes", [
    (torch.bfloat16, torch.bfloat16, torch.float32, 1 | 2 | 8, 24),
    (torch.bfloat16, torch.float32, torch.float32, 1 | 8, 28),
    (torch.float32, torch.float32, torch.float32, 8, 32),
    (torch.float32, torch.bfloat16, torch.bfloat16, 2 | 4 | 8, 20)])
def test_adamw_leaf_code_and_bytes(ptype, gtype, stype, code, nbytes):
    """``kernels/adamw.py``'s leaf codes (bit 0 bf16 p, 1 bf16 g, 2 bf16
    moments, 3 all four 16-byte aligned; a view one element in is not)
    and bytes a parameter, and its launch pairs (one per 512 leaves)."""
    from repro_torch.kernels import adamw as kadamw
    p, g, m, v = (torch.zeros(64, dtype=t)
                  for t in (ptype, gtype, stype, stype))
    assert kadamw.leaf_code(p, g, m, v) == code
    assert kadamw.leaf_code(p, g[1:33], m, v) == code & ~8
    assert kadamw.bytes_moved([p], [g], [m], [v]) == 64 * nbytes
    assert [kadamw.chunks(k) for k in (1, 512, 513, 1024, 1025)] == [
        1, 1, 2, 2, 3]


def test_train_step_trajectory_matches_jax():
    jcfg, tcfg = _cfgs("qwen1.5-0.5b")
    ocfg = dict(lr=1e-3, warmup_steps=1)
    jinit, jstep = j_loop.make_train_step(jcfg, j_loop.TrainConfig(
        optimizer=j_opt.AdamWConfig(**ocfg)))
    jparams, jstate = jinit(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tinit, tstep = make_train_step(tcfg, TrainConfig(
        optimizer=AdamWConfig(**ocfg)), CPU)
    params = bridge.params_to_torch(tree, tcfg, CPU, trainable=True)
    tstate = adamw_init(params, AdamWConfig(**ocfg))
    jstep = jax.jit(jstep)
    jl, tl = [], []
    for i in range(3):
        jbatch, tbatch = _batch(jcfg, b=4, s=32, seed=10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        params, tstate, tm = tstep(params, tstate, tbatch)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,layers", [("qwen1.5-0.5b", None),
                                         ("zamba2-1.2b", 7),
                                         ("whisper-large-v3", None),
                                         ("llama-3.2-vision-90b", None),
                                         ("deepseek-v3-671b", None)])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_gradients_of_no_remat(arch, layers, remat):
    grads = {}
    for policy in ("none", remat):
        _, tcfg = _cfgs(arch, layers, remat=policy)
        params = build_model(tcfg, CPU).init(0, trainable=True)
        _, tbatch = _batch(tcfg)
        (loss, _), g = value_and_grad(lambda p, b: lm.loss_fn(p, tcfg, b),
                                      params, tbatch)
        grads[policy] = (loss, g)
    assert torch.equal(grads["none"][0], grads[remat][0])
    for k, g in grads["none"][1].items():
        assert torch.equal(g, grads[remat][1][k]), k


def test_launch_train_resumes_from_its_checkpoint(capsys):
    from repro_torch.launch import train as launch
    with tempfile.TemporaryDirectory() as d:
        argv = ["--device", "cpu", "--reduced", "--steps", "4", "--batch",
                "2", "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2"]
        hist = launch.main(argv)
        assert [h["step"] for h in hist] == [0, 3]
        assert Checkpointer(d).latest_step() == 4
        # resumed at step 4: it logs only its last step (a fresh run would
        # log step 0 too)
        hist = launch.main([*argv[:4], "6", *argv[5:], "--resume"])
        assert [h["step"] for h in hist] == [5]
    assert "step     5" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b"])
def test_synthetic_data_carries_the_source(arch):
    from repro_torch.launch.train import synthetic_data
    cfg = reduced(get_config(arch))
    a = next(synthetic_data(cfg, 2, 8, seed=4, device="cpu"))
    b = next(synthetic_data(cfg, 2, 8, seed=4, device="cpu"))
    src = "audio_frames" if cfg.encdec.enabled else "vision_embeds"
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a[src],
                                                                  b[src])
    assert int(a["tokens"].min()) >= 4
    assert a[src].shape[0] == 2 and a[src].dtype == torch.float32


# ---------------------------------------------------------------------------
# the no-backward guard, on the card route
# ---------------------------------------------------------------------------

def _grad(*shape, dtype=torch.float32):
    return torch.randn(*shape, dtype=dtype).requires_grad_()


def _absorbed_mla():
    """K2's MLA mode, the absorbed form: 576-wide queries over one latent
    head, the values its first 512 columns (the naive form, 192/128, has
    a backward)."""
    lat = _grad(1, 8, 1, 576)
    return ops.flash_attention(_grad(1, 4, 4, 576), lat, lat[..., :512],
                               q_offset=4, scale=192 ** -0.5)


GUARDED = {
    "decode_attention (K1)": lambda: ops.decode_attention(
        _grad(1, 4, 16), _grad(1, 8, 2, 16), _grad(1, 8, 2, 16),
        torch.full((1,), 8, dtype=torch.int32)),
    "flash_attention (K2) in window mode": lambda: ops.flash_attention(
        _grad(1, 4, 4, 16), _grad(1, 8, 2, 16), _grad(1, 8, 2, 16),
        window=4, kv_positions=torch.arange(8, dtype=torch.int32)),
    "flash_attention (K2) in MLA mode": lambda: _absorbed_mla(),
    "topk_retrieval (K3)": lambda: ops.topk_retrieval(
        _grad(2, 16), torch.randn(32, 16), 4),
    "int8_matmul (K4)": lambda: ops.int8_matmul(
        torch.ones(4, 16, dtype=torch.int8),
        torch.ones(16, 8, dtype=torch.int8), _grad(4, 1), _grad(1, 8)),
}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernels_without_a_backward_refuse_a_gradient_on_the_card(
        name, monkeypatch):
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    with pytest.raises(RuntimeError, match=name.replace("(", r"\(")
                       .replace(")", r"\)") + " has no backward kernel"):
        GUARDED[name]()


def test_only_k2_carries_a_gradient_and_inference_is_unguarded(monkeypatch):
    """On the CPU autograd differentiates K2's plain version; on the card
    route plain-mode K2 under grad takes FlashAttentionFn (its forward,
    the K2 wrapper with return_lse, stood in for by the plain version),
    as K5 takes SsdChunkFn (tests/test_torch_ssd_bwd.py): K2 and K5 carry
    a gradient; under no_grad nothing is guarded, K5 included."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ref
    q, k, v = _grad(1, 4, 4, 16), _grad(1, 8, 2, 16), _grad(1, 8, 2, 16)
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ != "FlashAttentionFnBackward"
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    calls = []

    def card_forward(q, k, v, *, return_lse, **mask):
        calls.append(return_lse)
        return ref.flash_attention_lse_ref(q, k, v, **mask)
    monkeypatch.setattr(k2, "flash_attention", card_forward)
    out = ops.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert calls == [True]
    monkeypatch.undo()
    monkeypatch.setattr(ops, "_on_card", lambda t: True)

    def k5():
        return ops.ssd_chunk(
            _grad(1, 1, 4, 2, 8), torch.rand(1, 1, 4, 2),
            torch.randn(1, 1, 4, 2, 8), torch.randn(1, 1, 4, 2, 8),
            -torch.rand(1, 1, 4, 2))
    with torch.no_grad():
        for name, call in {**GUARDED, "ssd_chunk (K5)": k5}.items():
            # the card route is taken, so the CPU tensors reach the CUDA
            # wrapper's own checks
            with pytest.raises(ValueError, match="CUDA"):
                call()


# ---------------------------------------------------------------------------
# the train step's profiler spans (core/spans.py)
# ---------------------------------------------------------------------------

REMATS = ["dots", "full", "none"]


def _profiled_step(remat, profiled):
    """One train step of reduced qwen1.5 (3 layers) under ``remat``, under
    a CPU ``torch.profiler`` or none; -> (cfg, events or None, loss,
    params, state)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b"), layers=3),
                              remat=remat)
    init, step = make_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=1)), CPU)
    params, opt = init(0)
    batch = next(_data(cfg, B=2, S=16))
    if not profiled:
        params, opt, m = step(params, opt, batch)
        return cfg, None, m["loss"], params, opt
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        params, opt, m = step(params, opt, batch)
    return cfg, prof.events(), m["loss"], params, opt


@pytest.mark.parametrize("remat", REMATS)
def test_train_step_spans_nest_in_order(remat):
    from repro_torch.core import spans as S
    cfg, events, _, _, _ = _profiled_step(remat, True)
    got = {}
    for e in events:
        if e.name in S.ALL_SPANS:
            got.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    (step,) = got[S.SPAN_TRAIN_STEP]
    phases = [got[n] for n in (S.SPAN_FORWARD, S.SPAN_BACKWARD,
                               S.SPAN_OPTIMIZER)]
    assert [len(p) for p in phases] == [1, 1, 1]
    (fw,), (bw,), (opt,) = phases
    assert step[0] <= fw[0] < fw[1] <= bw[0] < bw[1] <= opt[0] < opt[1] \
        <= step[1]
    blocks = got[S.SPAN_BLOCK]
    again = 0 if remat == "none" else cfg.num_layers
    assert len(blocks) == cfg.num_layers + again
    assert sum(fw[0] <= s and e <= fw[1] for s, e in blocks) == \
        cfg.num_layers
    assert sum(bw[0] <= s and e <= bw[1] for s, e in blocks) == again


@pytest.mark.parametrize("remat", REMATS)
def test_a_profiler_changes_no_value_of_the_step(remat):
    """The spans inside a selectively checkpointed block leave the saved
    and recomputed values as they were: loss, parameters and both
    moments bit-equal with the profiler on and off."""
    _, _, loss0, p0, s0 = _profiled_step(remat, False)
    _, _, loss1, p1, s1 = _profiled_step(remat, True)
    assert torch.equal(loss0, loss1)
    for (k, a), (_, b) in zip(p0.named_parameters(), p1.named_parameters()):
        assert torch.equal(a, b), k
    for k in s0.m:
        assert torch.equal(s0.m[k], s1.m[k]), k
        assert torch.equal(s0.v[k], s1.v[k]), k


def test_span_is_the_shared_null_context_without_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import spans as S
    off = S.span(S.SPAN_FORWARD)
    assert off is S.span(S.SPAN_BLOCK)
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = S.span(S.SPAN_FORWARD)
        assert on is not off
        with on:
            pass
    assert [e.name for e in prof.events()
            if e.name.startswith(S.PREFIX)] == [S.SPAN_FORWARD]
