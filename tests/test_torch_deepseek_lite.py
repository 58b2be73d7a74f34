"""DeepSeek-V2-Lite's mechanisms in the port against the plain float32
reference (``plain_deepseek_v2_lite.py``) on the CPU, at a small size with
seeded random weights: MLA with a direct ``wq`` in both forms and YaRN,
the dropless expert layer with gates not renormalised, DeepSeek-V2's
sequence-wise balance loss, one chip's share of an expert layer, a small
model's loss and every gradient, and prefill then decode through the
latent cache."""
import copy
import dataclasses
import pathlib
import sys

import pytest
import torch

import plain_deepseek_v2_lite as plain
from repro_torch.core import spans as S
from repro_torch.models import lm
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import options as OPT

CPU = torch.device("cpu")

# DeepSeek-V2-Lite's published config.json, less what says nothing of
# its shape
LITE = {"hidden_size": 2048, "num_attention_heads": 16,
        "num_key_value_heads": 16, "num_hidden_layers": 27,
        "first_k_dense_replace": 1, "intermediate_size": 10944,
        "moe_intermediate_size": 1408, "n_routed_experts": 64,
        "n_shared_experts": 2, "num_experts_per_tok": 6,
        "norm_topk_prob": False, "routed_scaling_factor": 1,
        "scoring_func": "softmax", "topk_method": "greedy", "seq_aux": True,
        "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64, "v_head_dim": 128, "rms_norm_eps": 1e-6,
        "rope_theta": 10000, "tie_word_embeddings": False,
        "vocab_size": 102400, "aux_loss_alpha": 0.001,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                         "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096,
                         "type": "yarn"}}

# the same architecture at a test's size: every mechanism kept, a
# 16-expert router over 4 held experts from the fifth on
TINY = {**LITE, "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "num_hidden_layers": 3,
        "intermediate_size": 96, "moe_intermediate_size": 32,
        "n_routed_experts": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "vocab_size": 256,
        "expert_share": {"router_experts": 16, "first_expert": 4}}


def port(conf, remat="dots"):
    return OPT.deepseek_from_hf(conf, dtype="float32", remat=remat)


def weights(conf, seed=0):
    """The port's parameters and the same weights as a plain dict; norm
    scales drawn too, so that a misplaced one shows."""
    cfg = port(conf)
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), CPU,
                            trainable=True)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if p.dim() == 1:
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=g))
    W = {k: v.detach().clone() for k, v in params.named_parameters()}
    return cfg, params, W


def rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# YaRN and MLA
# ---------------------------------------------------------------------------

def test_yarn_numbers_are_the_closed_form():
    """At DeepSeek-V2-Lite's rope: the correction range at dim 64, base
    10,000 and 4,096 positions is (floor 10.472, ceil 22.513) = (10, 23);
    the softmax scale is 192^-0.5 x (0.1 x 0.707 x ln 40 + 1)^2."""
    cfg = port(LITE)
    assert cfg.yarn.correction_range(64, 10000.0) == (10, 23)
    inv, scale = OPT.mla_rope(cfg, CPU)
    assert scale == pytest.approx(0.114721, abs=5e-7)
    assert scale == pytest.approx(192 ** -0.5 * 1.2608038 ** 2, rel=1e-6)
    extra = 1.0 / 10000.0 ** (torch.arange(0, 64, 2).float() / 64)
    assert torch.equal(inv[:11], extra[:11])          # ramp 0 up to 10
    assert torch.allclose(inv[23:], extra[23:] / 40, rtol=1e-6)
    i = torch.arange(32).float()
    ramp = ((i - 10) / 13).clamp(0, 1)
    assert torch.allclose(inv, extra / 40 * ramp + extra * (1 - ramp),
                          rtol=1e-6)
    assert torch.allclose(inv, plain.yarn_inv_freq(LITE), rtol=1e-6)
    assert plain.softmax_scale(LITE) == pytest.approx(scale, rel=1e-12)


def test_direct_wq_replaces_the_query_lora():
    cfg, params, _ = weights(TINY)
    mla = params.moe_blocks[0].mla
    assert {"wq_a", "q_norm", "wq_b"}.isdisjoint(dict(mla.named_parameters()))
    assert tuple(mla["wq"].shape) == (64, 4, 24)


def test_direct_wq_mla_naive_form_matches_reference():
    cfg, params, W = weights(TINY)
    x = torch.randn(1, 13, 64, generator=torch.Generator().manual_seed(3))
    inv, scale = OPT.mla_rope(cfg, CPU)
    with torch.no_grad():
        y, _ = MLA.mla_attention(params.moe_blocks[1].mla, x, cfg.mla,
                                 positions=torch.arange(13),
                                 theta=cfg.rope_theta, inv_freq=inv,
                                 scale=scale)
    want = plain.mla(TINY, W, "moe_blocks.1.mla.", x[0])
    assert rel(y[0], want) < 1e-5


def test_direct_wq_mla_absorbed_form_matches_the_naive_form():
    cfg, params, _ = weights(TINY)
    m, p = cfg.mla, params.moe_blocks[0].mla
    x = torch.randn(2, 11, 64, generator=torch.Generator().manual_seed(4))
    inv, scale = OPT.mla_rope(cfg, CPU)
    kw = dict(theta=cfg.rope_theta, inv_freq=inv, scale=scale)
    with torch.no_grad():
        full, _ = MLA.mla_attention(p, x, m, positions=torch.arange(11),
                                    **kw)
        cache = MLA.init_cache_mla(2, 11, m, torch.float32, CPU)
        pre, cache = MLA.mla_attention(p, x[:, :5], m,
                                       positions=torch.arange(5),
                                       cache=cache, cache_idx=0, **kw)
        ys = [pre]
        for t in range(5, 11):
            y, cache = MLA.mla_attention(p, x[:, t:t + 1], m,
                                         positions=torch.tensor([t]),
                                         cache=cache, cache_idx=t, **kw)
            ys.append(y)
    assert rel(torch.cat(ys, 1), full) < 1e-5


# ---------------------------------------------------------------------------
# the expert layer
# ---------------------------------------------------------------------------

def _layer_in(conf, seed=5, s=24, b=2):
    return torch.randn(b, s, conf["hidden_size"],
                       generator=torch.Generator().manual_seed(seed))


def _plain_layer(conf, W, prefix, x):
    ys, auxes = zip(*(plain.moe(conf, W, prefix, row) for row in x))
    return torch.stack(ys), torch.stack(auxes).mean()


def test_dropless_layer_keeps_every_row_a_capacity_would_drop():
    """A router biased toward the held experts sends most assignments to
    them, past what capacity 1.25 gives an expert; every one is computed,
    and the gates are the probabilities, not renormalised."""
    cfg, params, W = weights(TINY)
    moe = params.moe_blocks[0].moe
    with torch.no_grad():
        moe["router"][:, 4:8] += 2.0       # the held experts
    W["moe_blocks.0.moe.router"] = moe["router"].detach().clone()
    x = _layer_in(TINY)
    routing = OPT.routing_of(cfg)
    _, idx, _ = MOE._router(moe, x.reshape(-1, 64), cfg.moe, routing, 2)
    held = ((idx >= 4) & (idx < 8)).sum(0).sum()
    per_expert = torch.bincount(idx.reshape(-1), minlength=16)[4:8]
    # the capacity path's slots an expert of the 16-expert layer
    cap = MOE.capacity(48, dataclasses.replace(cfg.moe, num_experts=16),
                       1.25)
    assert int(per_expert.max()) > cap, "the bias must overflow capacity"
    MOE.EXPERT_ROWS.reset()
    with torch.no_grad():
        y, aux = MOE.moe_ffn_dropless(moe, x, cfg.moe, routing, layer=7)
    assert MOE.EXPERT_ROWS.read() == {7: per_expert.tolist()}
    assert sum(MOE.EXPERT_ROWS.read()[7]) == int(held)
    want, want_aux = _plain_layer(TINY, W, "moe_blocks.0.moe.", x)
    assert rel(y, want) < 1e-5
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    renorm = copy.deepcopy(TINY)
    renorm["norm_topk_prob"] = True
    other, _ = _plain_layer(renorm, W, "moe_blocks.0.moe.", x)
    assert rel(y, other) > 1e-2


def test_sequence_wise_balance_loss_by_hand():
    """DeepSeek-V2's loss: alpha x mean over sequences of sum_e f_e P_e,
    f_e = E/(k s) x the times e was chosen in the sequence, P_e the
    sequence's mean probability of e."""
    cfg, params, _ = weights(TINY)
    moe = params.moe_blocks[1].moe
    x = _layer_in(TINY, seed=6, s=10, b=3)
    _, idx, aux = MOE._router(moe, x.reshape(-1, 64), cfg.moe,
                              OPT.routing_of(cfg), 3)
    probs = torch.softmax(x.reshape(-1, 64) @ moe["router"].detach(), -1)
    want = 0.0
    for r in range(3):
        i = idx.reshape(3, 10, 6)[r].reshape(-1)
        f = torch.bincount(i, minlength=16).float() * 16 / (6 * 10)
        want += float((f * probs.reshape(3, 10, 16)[r].mean(0)).sum()) / 3
    assert float(aux.detach()) == pytest.approx(0.001 * want, rel=1e-6)


def test_eight_shares_add_up_to_the_uncut_layer():
    """One chip's share under expert parallelism: the outputs of the
    eight shares of a 64-expert layer, each 8 experts over the whole
    router, with the shared experts counted once, add up to the plain
    reference's layer with all 64 experts."""
    whole = {**TINY, "n_routed_experts": 64}
    whole.pop("expert_share")
    g = torch.Generator().manual_seed(8)
    d, ff = 64, 32
    W = {"router": torch.randn(d, 64, generator=g) * d ** -0.5,
         "w_gate": torch.randn(64, d, ff, generator=g) * d ** -0.5,
         "w_up": torch.randn(64, d, ff, generator=g) * d ** -0.5,
         "w_down": torch.randn(64, ff, d, generator=g) * ff ** -0.5,
         "shared_w_gate": torch.randn(d, 2 * ff, generator=g) * d ** -0.5,
         "shared_w_up": torch.randn(d, 2 * ff, generator=g) * d ** -0.5,
         "shared_w_down": torch.randn(2 * ff, d, generator=g) * 64 ** -0.5}
    x = _layer_in(TINY, seed=9)
    want, _ = _plain_layer(whole, W, "", x)
    shared = plain.swiglu(x, W["shared_w_gate"], W["shared_w_up"],
                          W["shared_w_down"])
    total = shared.clone()
    for c in range(8):
        part = {**TINY, "n_routed_experts": 8,
                "expert_share": {"router_experts": 64, "first_expert": 8 * c}}
        cfg = port(part)
        p = {k: (v[8 * c:8 * c + 8] if k in ("w_gate", "w_up", "w_down")
                 else v) for k, v in W.items()}
        with torch.no_grad():
            y, _ = MOE.moe_ffn_dropless(p, x, cfg.moe, cfg.routing)
        total += y - shared
    assert rel(total, want) < 1e-5


def test_grouped_products_in_bf16_are_the_per_expert_products():
    """The card's route (``torch._grouped_mm`` in bf16, group ends read
    on the device), an empty group included, forward and backward,
    against one product a group on the same bf16 operands in f32: bf16
    rounding of the outputs (2^-8 relative) is the tolerance."""
    g = torch.Generator().manual_seed(10)
    a = torch.randn(40, 64, generator=g).bfloat16().requires_grad_()
    w = (torch.randn(4, 64, 32, generator=g) / 8).bfloat16().requires_grad_()
    ends_host = [9, 9, 30, 40]
    y = MOE.grouped_mm(a, w, torch.tensor(ends_host), ends_host)
    gy = torch.randn(y.shape, generator=g).bfloat16()
    ga, gw = torch.autograd.grad(y, [a, w], gy)
    a32, w32 = a.detach().float().requires_grad_(), \
        w.detach().float().requires_grad_()
    y32 = MOE.grouped_mm(a32, w32, torch.tensor(ends_host), ends_host)
    ga32, gw32 = torch.autograd.grad(y32, [a32, w32], gy.float())
    for got, want in ((y, y32), (ga, ga32), (gw, gw32)):
        assert rel(got.float(), want) < 2 ** -7
    assert float(gw[1].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _tokens(seed=11, b=2, s=16, vocab=256):
    return torch.randint(0, vocab, (b, s),
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_loss_and_every_gradient_match_the_reference(remat):
    """A 3-layer model (one dense, two expert layers) in f32.  Tolerance
    2e-5 of each leaf's largest entry: both sides are f32 and differ only
    in the order of their sums (grouped products against one per expert,
    a scatter-add against adds in turn, the flash kernel's plain version
    against a softmax), a few ulps (6e-8) amplified through three layers
    and reductions over up to 96 terms."""
    cfg, params, W = weights(TINY)
    cfg = port(TINY, remat)
    toks = _tokens()
    loss, metrics = lm.loss_fn(params, cfg, {"tokens": toks,
                                             "labels": toks})
    named = list(params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    want_loss, want = plain.loss_and_grads(TINY, W, toks)
    assert float(loss) == pytest.approx(want_loss, rel=2e-5)
    assert float(metrics["aux"]) > 0
    for (name, _), gr in zip(named, grads):
        assert rel(gr, want[name]) < 2e-5, name


def test_expert_rows_restart_for_another_models_layer():
    """A layer's count adds up while its held experts and device stay the
    same, and restarts where another model's layer of that index (another
    number of held experts) takes its place."""
    MOE.EXPERT_ROWS.reset()
    MOE.EXPERT_ROWS.add(0, torch.tensor([3, 1]))
    MOE.EXPERT_ROWS.add(0, torch.tensor([2, 2]))
    assert MOE.EXPERT_ROWS.read() == {0: [5, 3]}
    MOE.EXPERT_ROWS.add(0, torch.tensor([1, 2, 3]))
    assert MOE.EXPERT_ROWS.read() == {0: [1, 2, 3]}
    MOE.EXPERT_ROWS.reset()


def test_remat_recompute_counts_no_rows_twice():
    cfg, params, _ = weights(TINY)
    toks = _tokens(12)
    MOE.EXPERT_ROWS.reset()
    with torch.no_grad():
        lm.apply(params, cfg, {"tokens": toks})
    once = MOE.EXPERT_ROWS.read()
    MOE.EXPERT_ROWS.reset()
    loss, _ = lm.loss_fn(params, cfg, {"tokens": toks, "labels": toks})
    loss.backward()
    assert MOE.EXPERT_ROWS.read() == once
    assert sorted(once) == [1, 2]


def test_expert_spans_nest_in_blocks_and_recompute():
    from torch.profiler import ProfilerActivity, profile
    cfg, params, _ = weights(TINY)
    toks = _tokens(13)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = lm.loss_fn(params, cfg, {"tokens": toks, "labels": toks})
        loss.backward()
    names = [e.name for e in prof.events() if e.name.startswith(S.PREFIX)]
    # two expert layers, each again in remat's recompute; the route's
    # span closes while the shared experts are queued and opens again
    want = {S.SPAN_MOE_ROUTE: 8, S.SPAN_MOE_EXPERTS: 4, S.SPAN_MOE_COMBINE: 4}
    assert {span: names.count(span) for span in S.MOE_SPANS} == want
    assert names.count(S.SPAN_BLOCK) == 6


def test_prefill_then_decode_through_the_latent_cache():
    """Logits of a prefill and then one token at a time through the
    absorbed form over the latent cache, against the no-cache forward,
    within 1e-3 (f32; the two forms sum in different orders)."""
    cfg, params, _ = weights(TINY)
    toks = _tokens(14, s=20)
    with torch.no_grad():
        full, _, _ = lm.apply(params, cfg, {"tokens": toks})
    cache = lm.init_cache(cfg, 2, 20, CPU)
    pre, _, cache = lm.apply(params, cfg, {"tokens": toks[:, :12]},
                             mode="prefill", cache=cache)
    assert float((pre - full[:, :12]).abs().max()) < 1e-3
    for t in range(12, 20):
        lg, _, cache = lm.apply(params, cfg, {"tokens": toks[:, t:t + 1]},
                                mode="decode", cache=cache)
        assert float((lg[:, 0] - full[:, t]).abs().max()) < 1e-3


def test_default_options_leave_a_model_as_it_was():
    """A ``DeepSeekConfig`` with no option set routes by capacity and
    ropes at ``rope_theta``, as the plain ``ModelConfig``."""
    from repro_torch.configs import get_config, reduced
    base = reduced(get_config("deepseek-v2-236b"), layers=3)
    fields = {f: getattr(base, f) for f in base.__dataclass_fields__}
    same = OPT.DeepSeekConfig(**fields)
    assert OPT.mla_rope(same, CPU) == (None, base.mla.qk_head_dim ** -0.5)
    assert not OPT.routing_of(same).dropless
    toks = _tokens(15, vocab=base.vocab_size)
    out = []
    for cfg in (base, same):
        params = lm.init_params(cfg, torch.Generator().manual_seed(1), CPU)
        with torch.no_grad():
            out.append(lm.apply(params, cfg, {"tokens": toks})[0])
    assert torch.equal(out[0], out[1])


def test_a_share_needs_dropless_routing():
    with pytest.raises(ValueError):
        OPT.RoutingConfig(router_experts=64)


def test_the_benchmarks_copy_is_the_plain_reference():
    """``hero_bench/reference/moe.py`` (products through its precision's
    ``mm``, attention by query blocks, layers recomputed, gradients
    accumulated a row at a time) computes the plain reference's loss and
    gradients, to f32 round-off."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from hero_bench.reference import moe as bench_ref
    _, _, W = weights(TINY)
    toks = _tokens(16)
    want_loss, want = plain.loss_and_grads(TINY, W, toks)
    block = bench_ref.Q_BLOCK
    try:
        bench_ref.Q_BLOCK = 5           # three blocks of a 16-row sequence
        got_loss, got = bench_ref.loss_and_grads(TINY, W, toks)
    finally:
        bench_ref.Q_BLOCK = block
    assert got_loss == pytest.approx(want_loss, rel=1e-6)
    for name in want:
        assert rel(got[name], want[name]) < 2e-5, name
