"""K5's backward (the gradients of the Mamba2 SSD intra-chunk term) on the
CPU: its plain version ``ref.ssd_chunk_bwd_ref`` against ``jax.vjp`` of
the JAX package's ``repro.kernels.ref.ssd_chunk_ref`` and against
``torch.autograd.grad`` through the port's ``ref.ssd_chunk_ref``; in f64
against autograd of an f64 forward; the card route (``ops.ssd_chunk`` ->
``SsdChunkFn``) wired with the kernels' plain versions standing in, one
reduced f32 zamba2 train step through it against ``jax.value_and_grad``;
and the backward's launch plan.

Tolerances: f32 gradients within 2e-5·max|want| + 1e-4·|want| (sums in
another order; the reference's cumsum is f32 and the port's f64 rounded
once, and at these decays |cs| stays under 40, where an f32 step is
4e-6); f64 within 1e-12·max|want| + 1e-10·|want|; the train step within
``tests/test_torch_training.py``'s limits (loss 1e-5 relative, every
gradient 2e-5 + 1e-4·|want|).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as k2b  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as k5  # noqa: E402
from repro_torch.kernels import ssd_chunk_bwd as k5b  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.training.train_loop import value_and_grad  # noqa: E402

NAMES = ("dx", "ddt", "dB", "dC", "ddA")


def _close(got, want, what, a=2e-5, r=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=a * scale, rtol=r,
                               err_msg=what)


def _inputs(Q, nc=1, b=2, H=4, P=16, N=16, G=1, pad=0, seed=0):
    """numpy inputs from a seed: x, B, C normal; dt in [0.05, 0.3) with
    the last ``pad`` rows of each chunk 0 (a padded chunk); dA = dt·A, A
    in [-1, -0.2]; B and C one per group (G, broadcast to the heads by
    the caller); cotangents dy, dS normal."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, nc, Q, H, P)).astype(f)
    dt = rng.uniform(0.05, 0.3, (b, nc, Q, H)).astype(f)
    if pad:
        dt[:, :, Q - pad:] = 0.0
    A = -np.linspace(0.2, 1.0, H).astype(f)
    dA = (dt * A).astype(f)
    Bg = rng.standard_normal((b, nc, Q, G, N)).astype(f)
    Cg = rng.standard_normal((b, nc, Q, G, N)).astype(f)
    dy = rng.standard_normal((b, nc, Q, H, P)).astype(f)
    dS = rng.standard_normal((b, nc, H, N, P)).astype(f)
    return x, dt, Bg, Cg, dA, dy, dS


def _heads(t, H):
    """(b,nc,Q,G,N) torch -> per head as the model passes it: a stride-0
    view for one group, else a repeat_interleave copy."""
    if t.shape[3] == 1:
        return t.expand(-1, -1, -1, H, -1)
    return t.repeat_interleave(H // t.shape[3], dim=3)


def _torch_args(x, dt, Bg, Cg, dA, dtype=torch.float32):
    H = x.shape[3]
    tx, tdt, tdA = (torch.from_numpy(a) for a in (x, dt, dA))
    tB, tC = (_heads(torch.from_numpy(a).to(dtype), H) for a in (Bg, Cg))
    return tx.to(dtype), tdt, tB, tC, tdA


def _jax_vjp(x, dt, Bg, Cg, dA, dy, dS):
    """jax.vjp of the reference's ssd_chunk_ref, B and C per head."""
    H = x.shape[3]
    Bh, Ch = (np.repeat(a, H // a.shape[3], axis=3) for a in (Bg, Cg))
    _, vjp = jax.vjp(j_ref.ssd_chunk_ref, *(jnp.asarray(a) for a in
                                            (x, dt, Bh, Ch, dA)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dS)))]


CASES = ([dict(Q=Q, nc=nc) for Q in (1, 4, 32, 77, 128) for nc in (1, 2)]
         + [dict(Q=64, nc=2, P=64, N=64), dict(Q=77, nc=2, pad=13)])


def _id(c):
    return "-".join(f"{k}{v}" for k, v in c.items())


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_plain_backward_matches_jax_vjp(case, G):
    """All five gradients of the plain version against jax.vjp of the
    reference's intra-chunk oracle, B and C one group broadcast to the
    heads (a stride-0 view) or two groups (a copy); a padded chunk's
    gradients finite."""
    args = _inputs(**case, G=G)
    want = _jax_vjp(*args)
    got = ref.ssd_chunk_bwd_ref(*_torch_args(*args[:5]),
                                *(torch.from_numpy(a) for a in args[5:]))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and bool(g.isfinite().all()), name
        _close(g.numpy(), w, f"{case} G={G} {name}")


@pytest.mark.parametrize("case", [dict(Q=32, nc=2), dict(Q=77, nc=1, G=2),
                                  dict(Q=128, nc=1, P=64, N=64),
                                  dict(Q=40, nc=2, pad=8)],
                         ids=["Q32", "Q77-G2", "Q128-P64", "padded"])
def test_plain_backward_matches_torch_autograd(case):
    """The same gradients against torch.autograd.grad through the port's
    own forward (ref.ssd_chunk_ref): dB and dC per head, and their sums
    over a group's heads through the broadcast."""
    x, dt, Bg, Cg, dA, dy, dS = _inputs(**case)
    H = x.shape[3]
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (x, dt, Bg, Cg, dA)]
    B, C = _heads(leaves[2], H), _heads(leaves[3], H)
    y, S = ref.ssd_chunk_ref(leaves[0], leaves[1], B, C, leaves[4])
    tdy, tdS = torch.from_numpy(dy), torch.from_numpy(dS)
    want = torch.autograd.grad((y, S), (leaves[0], leaves[1], B, C,
                                        leaves[4]), (tdy, tdS),
                               retain_graph=True)
    got = ref.ssd_chunk_bwd_ref(leaves[0].detach(), leaves[1].detach(),
                                B.detach(), C.detach(), leaves[4].detach(),
                                tdy, tdS)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w.numpy(), f"{case} {name}")
    want_g = torch.autograd.grad((y, S), leaves[2:4], (tdy, tdS))
    G = Bg.shape[3]
    for name, g, w in zip(("dB", "dC"), got[2:4], want_g):
        summed = g.reshape(*g.shape[:3], G, H // G, -1).sum(4)
        _close(summed.numpy(), w.numpy(), f"{case} group {name}")


def _fwd64(x, dt, B, C, dA):
    """The forward in f64 (ssd_chunk_ref computes in f32) but for cs,
    rounded once to f32 as every version of the forward rounds it (the
    rounding outside the graph: a cast would round cs's gradient too)."""
    dtx = x * dt[..., None]
    cs = torch.cumsum(dA, 2)
    cs = cs + (cs.float().double() - cs).detach()
    Q = x.shape[2]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    lower = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.exp(seg.masked_fill(~lower[None, None, :, :, None],
                                  float("-inf")))
    s = torch.einsum("bcqhn,bckhn->bcqkh", C, B)
    y = torch.einsum("bcqkh,bckhp->bcqhp", s * L, dtx)
    w = torch.exp(cs[:, :, -1:, :] - cs)
    S = torch.einsum("bcqhn,bcqhp->bchnp", B * w[..., None], dtx)
    return y, S


@pytest.mark.parametrize("Q,pad", [(1, 0), (33, 0), (77, 5)])
def test_plain_backward_is_the_exact_gradient_in_f64(Q, pad):
    """Given f64 inputs the plain version computes in f64: the derivation
    (row minus column sums of G, the forward sum of the w terms) is the
    exact gradient of the f64 forward."""
    args = [torch.from_numpy(a).double() for a in
            _inputs(Q, nc=2, G=2, pad=pad, seed=5)]
    x, dt, Bg, Cg, dA, dy, dS = args
    leaves = [t.clone().requires_grad_() for t in (x, dt, Bg, Cg, dA)]
    B, C = (_heads(t, x.shape[3]) for t in leaves[2:4])
    y, S = _fwd64(leaves[0], leaves[1], B, C, leaves[4])
    want = torch.autograd.grad((y, S), (leaves[0], leaves[1], B, C,
                                        leaves[4]), (dy, dS))
    got = ref.ssd_chunk_bwd_ref(x, dt, _heads(Bg, x.shape[3]),
                                _heads(Cg, x.shape[3]), dA, dy, dS)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64, name
        _close(g.numpy(), w.numpy(), f"Q={Q} {name}", a=1e-12, r=1e-10)
    assert float(got[4][:, :, 0].abs().max()) < 1e-12   # ddA_0 is 0


# ---------------------------------------------------------------------------
# the card route, wired on the CPU with the plain versions standing in
# ---------------------------------------------------------------------------

@pytest.fixture
def card_route(monkeypatch):
    """ops' card route taken for CPU tensors, each kernel wrapper of the
    train path (K2 with its LSE and K2's backward, K5 and K5's backward)
    stood in for by its plain version; -> the stand-ins' call counts."""
    calls = {"ssd_chunk": 0, "ssd_chunk_bwd": 0, "flash_attention_bwd": 0}

    def count(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    def k2_forward(q, k, v, *, return_lse, **mask):
        assert return_lse
        return ref.flash_attention_lse_ref(q, k, v, **mask)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(k2, "flash_attention", k2_forward)
    monkeypatch.setattr(k2b, "flash_attention_bwd",
                        count("flash_attention_bwd",
                              ref.flash_attention_bwd_ref))
    monkeypatch.setattr(k5, "ssd_chunk", count("ssd_chunk",
                                               ref.ssd_chunk_ref))
    monkeypatch.setattr(k5b, "ssd_chunk_bwd", count("ssd_chunk_bwd",
                                                    ref.ssd_chunk_bwd_ref))
    return calls


def test_card_route_takes_ssd_chunk_fn_under_grad(card_route):
    """Under grad with an input that requires one, ops.ssd_chunk returns
    SsdChunkFn's outputs, and its backward (K5's backward) gives the
    plain version's gradients; under no_grad the forward alone runs."""
    x, dt, Bg, Cg, dA, dy, dS = _inputs(24, nc=2, G=1, seed=7)
    tx, tdt, tB, tC, tdA = _torch_args(x, dt, Bg, Cg, dA)
    leaves = [t.clone().requires_grad_() for t in (tx, tdt, tdA)]
    y, S = ops.ssd_chunk(leaves[0], leaves[1], tB, tC, leaves[2])
    assert type(y.grad_fn).__name__ == "SsdChunkFnBackward"
    assert card_route["ssd_chunk"] == 1
    got = torch.autograd.grad((y, S), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(dS)))
    assert card_route["ssd_chunk_bwd"] == 1
    want = ref.ssd_chunk_bwd_ref(tx, tdt, tB, tC, tdA, torch.from_numpy(dy),
                                 torch.from_numpy(dS))
    for name, g, w in zip(("dx", "ddt", "ddA"), got, (want[0], want[1],
                                                     want[4])):
        assert torch.equal(g, w), name
    with torch.no_grad():
        y, _ = ops.ssd_chunk(*leaves[:2], tB, tC, leaves[2])
    assert y.grad_fn is None and card_route["ssd_chunk"] == 2


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, j_build(jcfg).init(
        jax.random.PRNGKey(seed)))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reduced_zamba2_trains_through_the_card_route(card_route):
    """Reduced f32 zamba2 (7 layers: a group of 6 Mamba2 layers, the
    shared block, a tail layer; 2 x 40 tokens, two chunks of 32 with a
    padded tail) through the card route: the loss and every gradient of
    jax.value_and_grad within test_torch_training's limits, K5's
    backward once per Mamba2 layer and K2's once per shared-block
    pass."""
    jcfg = j_reduced(j_get_config("zamba2-1.2b"), layers=7)
    tcfg = reduced(get_config("zamba2-1.2b"), layers=7)
    assert dataclasses.asdict(tcfg.ssm) == dataclasses.asdict(jcfg.ssm)
    tree = _jax_params(jcfg)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tt = torch.from_numpy(toks).long()
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_lm.loss_fn(p, jcfg, jbatch), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    params = bridge.params_to_torch(tree, tcfg, "cpu", trainable=True)
    (tloss, _), tgrads = value_and_grad(
        lambda p, b: lm.loss_fn(p, tcfg, b), params,
        {"tokens": tt, "labels": tt})
    assert card_route["ssd_chunk_bwd"] == tcfg.num_layers
    assert card_route["flash_attention_bwd"] == (
        tcfg.num_layers // tcfg.ssm.attn_every)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = _leaves(jgrads)
    got = _leaves(bridge.grads_from_torch(params, tgrads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=1e-4,
                                   err_msg=f"zamba2 gradient {k}")
    assert all(np.abs(want[k]).max() > 0 for k in want if "A_log" in k)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plan_fits_an_h100_at_every_chunk_length(dtype):
    """ssd_bwd_tiles' shared memory fits an H100 block's limit at every Q
    from 1 to 256, two blocks an SM; its grid has two role tiles per 64
    rows, the finishing kernel a block per (head, batch x chunk)."""
    for Q in range(1, 257):
        p = k5b.plan(4, 2, Q, 64, 64, 64, dtype)
        assert p.smem <= k5b.H100[1] and 2 * p.smem <= 228 * 1024 - 2048
        assert p.tiles == (64, 8, 2 * -(-Q // 64)) and p.finish == (64, 8)


@pytest.mark.parametrize("P,N,Q", [(65, 64, 32), (64, 65, 32), (64, 64, 257),
                                   (16, 16, 0)])
def test_backward_plan_refuses_what_the_kernel_does_not_take(P, N, Q):
    with pytest.raises(ValueError, match="ssd_chunk_bwd"):
        k5b.plan(1, 1, Q, 4, P, N, torch.float32)
    with pytest.raises(ValueError, match="ssd_chunk_bwd"):
        k5b.plan(1, 1, 32, 4, 16, 16, torch.float16)


def test_backward_bound_counts_the_train_shape():
    """flops and bytes_moved at the hybrid train shape (b 4, two chunks
    of 256, 64 heads of P = N = 64, B and C one group): 25.2 MFLOP a
    cell, 12.9 GFLOP a launch, about 112 MB in bf16."""
    x = torch.empty((4, 2, 256, 64, 64), dtype=torch.bfloat16)
    dt = torch.empty((4, 2, 256, 64))
    B = torch.empty((4, 2, 256, 1, 64),
                    dtype=torch.bfloat16).expand(-1, -1, -1, 64, -1)
    work = k5b.flops(x, B)
    total = sum(n for n, _ in work)
    assert work[0][1] == torch.bfloat16 and work[1][1] == "tf32x3"
    assert abs(total / 512 - 25.2e6) < 0.1e6 and abs(total - 12.9e9) < 0.1e9
    assert 105e6 < k5b.bytes_moved(x, dt, B, B, dt) < 115e6


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_card_route_under_remat_recomputes_k5_and_keeps_the_gradients(
        card_route, remat):
    """Remat (as the full-width train path runs it, "dots") around the
    card route: each Mamba2 layer's K5 runs again in the backward, K5's
    backward still once a layer, and the loss and every gradient equal
    those without remat."""
    from repro_torch.models import build_model
    out = {}
    for policy in ("none", remat):
        cfg = dataclasses.replace(reduced(get_config("zamba2-1.2b"),
                                          layers=7), remat=policy)
        params = build_model(cfg, "cpu").init(0, trainable=True)
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (2, 40)))
        for k in card_route:
            card_route[k] = 0
        out[policy] = value_and_grad(lambda p, b: lm.loss_fn(p, cfg, b),
                                     params, {"tokens": toks,
                                              "labels": toks})
        assert card_route["ssd_chunk"] == cfg.num_layers * (
            1 if policy == "none" else 2), (policy, card_route)
        assert card_route["ssd_chunk_bwd"] == cfg.num_layers, card_route
    (l0, _), g0 = out["none"]
    (l1, _), g1 = out[remat]
    assert torch.equal(l0, l1)
    for k, g in g0.items():
        assert torch.equal(g, g1[k]), k


def test_profile_serve_hybrid_train_runner_runs_on_the_cpu():
    """The steps ``profile_serve --path train-hybrid`` profiles (and
    chip_smoke's hybrid train phase times): reduced zamba2 on the CPU."""
    from repro_torch.launch import profile_serve
    run = profile_serve.train_runner(torch.device("cpu"), "train-hybrid")
    first, second = run(), run()
    assert first["steps"] == profile_serve.TRAIN_PROFILE_STEPS
    assert first["tokens"] == (profile_serve.TRAIN_PROFILE_STEPS
                               * profile_serve.HYBRID_BATCH
                               * profile_serve.HYBRID_SEQ)
    assert np.isfinite(first["loss"]) and second["loss"] < first["loss"]
