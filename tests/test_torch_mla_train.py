"""DeepSeek's naive MLA form on K2's generic route, on the CPU: the widened
plain versions (keys 192, values 128, the scale 1/sqrt(192), n = h)
against ``jax.vjp`` of a jnp transcription of
``repro/models/mla.py``'s no-cache scores, mask and softmax, and against
torch autograd in f64; ``FlashAttentionFn`` with the scale on the card
route, wired with the plain versions standing in, training the published
MLA widths of deepseek-v2 and v3 (v3's MTP head included) against
``jax.value_and_grad``; the Python mirrors of the widened kernels' shared
memory and their launch plans at the moe train phase's shape; and
``ops``' routing of the naive and absorbed forms under grad.

Tolerances: the plain versions within 1e-5 (atol and rtol: f32 sums in
another order over 40 keys and 192 features) of the JAX transcription
and of the f64 gradient; the train step within
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
from repro.models import build_model as j_build  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as k2b  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.profile_serve import (  # noqa: E402
    MOE_BATCH, MOE_SEQ, published_mla_config)
from repro_torch.models import lm  # noqa: E402
from repro_torch.training.train_loop import value_and_grad  # noqa: E402

NOPE, ROPE, V = 128, 64, 128          # deepseek-v2/v3's MLA widths
SCALE = (NOPE + ROPE) ** -0.5
H100_SMEM = 232448                    # bytes a block may opt into


def _naive_inputs(b=2, s=40, h=4, seed=22):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(shape).astype(np.float32)
            for name, shape in (("q_nope", (b, s, h, NOPE)),
                                ("q_rope", (b, s, h, ROPE)),
                                ("k_nope", (b, s, h, NOPE)),
                                ("k_rope", (b, s, ROPE)),
                                ("v", (b, s, h, V)),
                                ("do", (b, s, h, V)))}


def _jax_naive(q_nope, q_rope, k_nope, k_rope, v):
    """repro/models/mla.py's no-cache attention, in f32: scores over the
    nope part per head and the rope part shared by the heads, times
    1/sqrt(192), causal, softmax, then the per-head values."""
    s = q_nope.shape[1]
    scores = (jnp.einsum("bqhe,bkhe->bhqk", q_nope, k_nope)
              + jnp.einsum("bqhe,bke->bhqk", q_rope, k_rope)) * SCALE
    pos = jnp.arange(s)
    scores = jnp.where((pos[:, None] >= pos[None])[None, None], scores,
                       -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhqk,bkhe->bqhe", probs, v), scores


def _torch_qkv(x, dtype=torch.float32):
    """q (b, s, h, 192), k (b, s, h, 192) with the rope part broadcast
    over the heads (as ``models/mla.py`` builds them), v (b, s, h, 128)."""
    t = {n: torch.from_numpy(a).to(dtype) for n, a in x.items()}
    h = t["q_nope"].shape[2]
    q = torch.cat([t["q_nope"], t["q_rope"]], -1)
    k = torch.cat([t["k_nope"], t["k_rope"][:, :, None].expand(
        -1, -1, h, -1)], -1)
    return q, k, t["v"], t["do"]


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


def test_plain_versions_match_jax_vjp_of_the_naive_mla_form():
    """flash_attention_lse_ref's output and LSE, and
    flash_attention_bwd_ref's dq, dk, dv from them, against jax.vjp of the
    reference's naive form: dq's and dk's columns split into the nope and
    rope parts, dk's rope part summed over the heads that share it."""
    x = _naive_inputs()
    args = [jnp.asarray(x[n]) for n in ("q_nope", "q_rope", "k_nope",
                                        "k_rope", "v")]
    (want, scores), vjp = jax.vjp(_jax_naive, *args)
    grads = vjp((jnp.asarray(x["do"]), jnp.zeros_like(scores)))
    q, k, v, do = _torch_qkv(x)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=True,
                                           scale=SCALE)
    assert out.shape == v.shape and lse.shape == (2, 4, 40)
    _close(out, want)
    _close(lse, jax.scipy.special.logsumexp(scores, axis=-1))
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, do, lse,
                                             causal=True, scale=SCALE)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    dq_nope, dq_rope, dk_nope, dk_rope, dv_want = grads
    _close(dq[..., :NOPE], dq_nope)
    _close(dq[..., NOPE:], dq_rope)
    _close(dk[..., :NOPE], dk_nope)
    _close(dk[..., NOPE:].sum(2), dk_rope)
    _close(dv, dv_want)


def test_plain_backward_is_autograd_of_the_plain_forward_in_f64():
    """The step-by-step backward at (192, 128) against torch autograd of
    flash_attention_ref in f64 (causal, n = h, the explicit scale)."""
    x = _naive_inputs(seed=23)
    q, k, v, do = _torch_qkv(x)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=True,
                                           scale=SCALE)
    got = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=True,
                                      scale=SCALE)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want_out = ref.flash_attention_ref(*leaves, causal=True, scale=SCALE)
    want = torch.autograd.grad(want_out, leaves, do.double())
    _close(out, want_out.detach())
    for g, w in zip(got, want):
        _close(g, w)


@pytest.fixture
def card_route(monkeypatch):
    """ops' card route taken for CPU tensors, K2 with its LSE and K2's
    backward stood in for by their plain versions; each call's (key,
    value) widths and scale are recorded."""
    calls = {"forward": [], "backward": []}

    def k2_forward(q, k, v, *, return_lse=False, scale=None, **mask):
        calls["forward"].append((k.shape[-1], v.shape[-1], scale))
        if not return_lse:      # under no_grad: ops passes the window mode
            return ref.flash_attention_ref(q, k, v, scale=scale, **mask)
        return ref.flash_attention_lse_ref(q, k, v, scale=scale, **mask)

    def k2_backward(q, k, v, o, do, lse, *, scale=None, **mask):
        calls["backward"].append((k.shape[-1], v.shape[-1], scale))
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse, scale=scale,
                                           **mask)
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(k2, "flash_attention", k2_forward)
    monkeypatch.setattr(k2b, "flash_attention_bwd", k2_backward)
    return calls


def test_naive_pair_under_grad_takes_flash_attention_fn(card_route):
    """Under grad the naive pair goes to FlashAttentionFn with its scale,
    whose backward gives the plain version's gradients; the absorbed pair
    still raises; under no_grad the forward alone runs."""
    x = _naive_inputs(b=1, s=24, h=2, seed=5)
    q, k, v, do = _torch_qkv(x)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, scale=SCALE)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, do)
    assert card_route["forward"] == card_route["backward"] == [
        (192, 128, SCALE)]
    o, lse = ref.flash_attention_lse_ref(q, k, v, causal=True, scale=SCALE)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True,
                                       scale=SCALE)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    lat = torch.randn(1, 24, 1, 576, requires_grad=True)
    with pytest.raises(RuntimeError, match="in MLA mode has no backward"):
        ops.flash_attention(torch.randn(1, 4, 2, 576, requires_grad=True),
                            lat, lat[..., :512], q_offset=20, scale=SCALE)
    with torch.no_grad():
        out = ops.flash_attention(*leaves, causal=True, scale=SCALE)
    assert out.grad_fn is None and len(card_route["forward"]) == 2


def _published_pair(arch):
    """(JAX, port) configs: ``published_mla_config``'s small f32 DeepSeek
    with the published MLA widths (2 layers, 8 heads), and its twin in
    the JAX package, built the same way."""
    tcfg = published_mla_config(arch)
    jfull = j_get_config(arch)
    jcfg = dataclasses.replace(
        j_reduced(jfull, layers=2, d_model=256), mla=jfull.mla,
        num_heads=8, num_kv_heads=8, head_dim=jfull.mla.v_head_dim)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_published_mla_widths_train_through_the_card_route(arch,
                                                           card_route):
    """The loss and every gradient of a train step through the card route
    (FlashAttentionFn at (192, 128) with the scale, once per attention
    block: the 2 layers and v3's MTP block) against jax.value_and_grad of
    the JAX package's twin on bridged weights."""
    jcfg, tcfg = _published_pair(arch)
    tree = jax.tree.map(np.asarray, j_build(jcfg).init(
        jax.random.PRNGKey(0)))
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tt = torch.from_numpy(toks).long()
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: j_lm.loss_fn(p, jcfg, jbatch), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    params = bridge.params_to_torch(tree, tcfg, "cpu", trainable=True)
    (tloss, tmet), tgrads = value_and_grad(
        lambda p, b: lm.loss_fn(p, tcfg, b), params,
        {"tokens": tt, "labels": tt})
    blocks = tcfg.num_layers + tcfg.mtp_depth
    assert (tcfg.mtp_depth > 0) == (arch == "deepseek-v3-671b")
    assert card_route["backward"] == [(192, 128, SCALE)] * blocks
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = _leaves(jgrads)
    got = _leaves(bridge.grads_from_torch(params, tgrads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=1e-4,
                                   err_msg=f"{arch} gradient {k}")
    assert all(np.abs(want[k]).max() > 0 for k in want if "wk_b" in k)


# the moe train phase's K2 calls: b 2, 512 positions, n = h = 128
PHASE = dict(b=MOE_BATCH, sq=MOE_SEQ, h=128)


def _smem_bytes(kernel, ek, ev):
    """Dynamic shared memory of a block of ``kernel`` at (key, value)
    widths (ek, ev), as ``csrc/flash_attention.cu`` (``Tile``,
    ``smem_bytes``) and ``csrc/flash_attention_bwd.cu`` (``WTile``,
    ``smem_bytes``) lay it out.  flash_fwd_wgmma: the 1 KB swizzle
    alignment, the Q tile and 2 (ek >= 128) or 3 stages of a K and a V
    tile, 64 rows of bf16 each, and the barriers; flash_fwd: f32 Q, K, V,
    P tiles of 32 rows (K, V padded a column) and two row vectors; the
    wgmma backward passes a resident pair of 64-row tiles (ek and ev
    wide) and 3 streamed pairs (2 for the dK/dV pass at (128, 128) and
    for the dQ pass past e = 16), each stage's 64 16-byte RowInfo, the
    barriers; the CUDA-core backward four f32 tiles padded a column, P
    and dS, and the rows' LSE and D."""
    tile = k2.KEY_TILE
    if kernel == "flash_fwd_wgmma":
        stages = 2 if ek >= 128 else 3
        return (1024 + tile * ek * 2 + stages * tile * (ek + ev) * 2
                + 8 * (stages + 1))
    if kernel == "flash_fwd":
        return 4 * (32 * ek + 32 * (ek + 1) + 32 * (ev + 1) + 32 * 32 + 64)
    if kernel in ("flash_bwd_dkdv", "flash_bwd_dq"):
        return 4 * (2 * tile * (ek + 1) + 2 * tile * (ev + 1)
                    + 2 * tile * (tile + 1) + 2 * tile)
    stages = ((2 if (ek, ev) == (128, 128) else 3)
              if kernel == "flash_bwd_dkdv_wgmma" else 3 if ek == 16 else 2)
    return (1024 + tile * (ek + ev) * 2 * (1 + stages) + tile * 16 * stages
            + 8 * (stages + 1))


@pytest.mark.parametrize("kernel,want", [
    ("flash_fwd_wgmma", 107544), ("flash_fwd", 70144),
    ("flash_bwd_dkdv_wgmma", 167968), ("flash_bwd_dq_wgmma", 125976),
    ("flash_bwd_dkdv", 198656), ("flash_bwd_dq", 198656)])
def test_widened_kernels_fit_shared_memory(kernel, want):
    """The mirrors of the kernels' shared memory at (192, 128) fit the
    232,448 bytes a block may opt into; at (128, 128) they read what the
    kernels took before the widths were split.  The dK/dV pass's second
    warpgroup's sums (96 + 64 f32 a thread of 128) fit the tiles it
    reuses for the reduction (the resident pair and three stages)."""
    assert _smem_bytes(kernel, *k2.NAIVE_MLA) == want <= H100_SMEM
    assert _smem_bytes(kernel, 128, 128) == {
        "flash_fwd_wgmma": 82968, "flash_fwd": 53760,
        "flash_bwd_dkdv_wgmma": 101400, "flash_bwd_dq_wgmma": 101400,
        "flash_bwd_dkdv": 165888, "flash_bwd_dq": 165888}[kernel]
    assert (192 + 128) // 2 * 128 * 4 <= 64 * (192 + 128) * 2 * (1 + 3)


def test_plans_at_the_moe_train_shape():
    """The forward's and both backward routes' plans at the phase's shape
    give whole splits covering the causal key range: 2 x 128 x 8 query
    tiles and key blocks, no split needed."""
    b, sq, h = PHASE["b"], PHASE["sq"], PHASE["h"]
    per_tile, mtiles, chunk, nsplit = k2.plan(b, sq, h, h, sq, True, 0)
    assert (per_tile, mtiles) == (64, 8) and chunk * nsplit >= sq
    assert chunk % k2.KEY_TILE == 0 and (nsplit - 1) * chunk < sq
    p = k2b.wgmma_plan(b, sq, h, h, sq, sq, True, 0)
    assert (p.per_tile, p.mtiles, p.kv_nsplit, p.nsplit) == (64, 8, 1, 1)
    assert p.chunk % k2b.TILE == 0 and p.chunk * p.nsplit >= sq
    chunk, nsplit = k2b.plan(b, sq, h, sq, True, 0)
    assert chunk % k2b.TILE == 0 and (nsplit - 1) * chunk < sq <= (
        nsplit * chunk)


def test_naive_form_bound_at_the_moe_train_shape():
    """The bytes and operations the phase's K2 calls must take: forward
    q, k (192) and v, o (128) once, 168 MB; backward those plus dO and
    the three gradients and the LSE, 336 MB, over the five products'
    2·pairs·h·b·(3·192 + 2·128) flops, 55.9 GFLOP."""
    b, sq, h = PHASE["b"], PHASE["sq"], PHASE["h"]
    q = torch.empty(b, sq, h, 192, dtype=torch.bfloat16, device="meta")
    v = torch.empty(b, sq, h, 128, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(b, h, sq, device="meta")
    pairs = k2.visible_pairs(sq, sq, True, 0)
    assert pairs == 131328
    assert k2.bytes_moved(q, q, sq, ev=128) == 2 * b * sq * h * 320 * 2
    assert k2.flops(q, sq, True, 0, ev=128) == 2 * b * h * 320 * pairs
    assert k2b.bytes_moved(q, q, lse, v) == (
        4 * b * sq * h * 192 * 2 + 4 * b * sq * h * 128 * 2 + b * h * sq * 4)
    assert k2b.flops(q, sq, True, 0, ev=128) == 2 * pairs * h * b * (
        3 * 192 + 2 * 128)
    assert round(k2b.flops(q, sq, True, 0, ev=128) / 1e9, 1) == 55.9


def test_profile_serve_moe_train_runner_runs_on_the_cpu():
    """The steps ``profile_serve --path train-moe`` profiles (and
    chip_smoke's moe train phase times): reduced deepseek-v2 on the
    CPU."""
    from repro_torch.launch import profile_serve
    run = profile_serve.train_runner(torch.device("cpu"), "train-moe")
    first, second = run(), run()
    assert first["steps"] == profile_serve.TRAIN_PROFILE_STEPS
    assert first["tokens"] == (profile_serve.TRAIN_PROFILE_STEPS * MOE_BATCH
                               * MOE_SEQ)
    assert np.isfinite(first["loss"]) and second["loss"] < first["loss"]
