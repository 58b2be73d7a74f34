"""The moe family's cell on the CPU: a tiny DeepSeek-V2-Lite-shaped
configuration (every mechanism, widths cut) runs ``measure`` through the
family's files and comes out correct, and not correct with half the
batch; the family's weight scales and step FLOPs are the hand-worked
numbers; the configuration states its cut."""
import copy
import time

import pytest
import torch

from hero_bench import registry
from hero_bench.report import measure
from hero_bench.tests import tiny

CELL = "deepseek-v2-lite-ep8-train-4x8192"
SEED = 3_000_000_019

TINY_MOE = {"hidden_size": 64, "num_attention_heads": 4,
            "num_key_value_heads": 4, "num_hidden_layers": 3,
            "intermediate_size": 96, "moe_intermediate_size": 32,
            "n_routed_experts": 4, "kv_lora_rank": 32,
            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
            "v_head_dim": 16, "vocab_size": 256,
            "expert_share": {"router_experts": 16, "first_expert": 4}}


def tiny_cell():
    wl = copy.deepcopy(registry.load_workload(CELL))
    conf = copy.deepcopy(registry.load_config(wl["config"]))
    conf.update(copy.deepcopy(TINY_MOE))
    conf["dtype"] = "float32"
    wl["mix"].update(batch=2, seq=16)
    return wl, conf


def test_tiny_moe_cell_is_correct():
    wl, conf = tiny_cell()
    res, _ = measure(wl, SEED, 0.5, False, torch.device("cpu"),
                     time.monotonic(), bench=tiny.bench(), conf=conf)
    assert res["correct"], res["checks"]
    assert {"train_tokens_per_s", "setup_s"} <= set(res["metrics"])


def test_tiny_moe_cell_catches_the_half_batch_fault(monkeypatch):
    from repro_torch.models import lm
    loss_fn = lm.loss_fn

    def half(params, cfg, batch):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(params, cfg, {k: v[:rows] for k, v in batch.items()})
    monkeypatch.setattr(lm, "loss_fn", half)
    wl, conf = tiny_cell()
    res, _ = measure(wl, SEED, 0.5, False, torch.device("cpu"),
                     time.monotonic(), bench=tiny.bench(), conf=conf)
    assert not res["correct"]


def test_expert_load_is_read_from_the_programs_count():
    from repro_torch.models import moe
    reader = registry.load_metric("expert_load_max.train")
    moe.EXPERT_ROWS.reset()
    assert reader.read(None) is None
    moe.EXPERT_ROWS.add(1, torch.tensor([3, 1]))
    moe.EXPERT_ROWS.add(2, torch.tensor([5, 5]))
    moe.EXPERT_ROWS.add(1, torch.tensor([3, 1]))
    assert reader.read(None) == pytest.approx(6 / 4)
    moe.EXPERT_ROWS.reset()


def test_weight_scales_by_hand():
    conf = registry.load_config("deepseek-v2-lite-ep8")
    fam = registry.load_family("moe")
    d, ff = 2048, 1408
    want = {("moe_blocks.0.moe.w_gate", (8, d, ff)): d ** -0.5,
            ("moe_blocks.0.moe.w_up", (8, d, ff)): d ** -0.5,
            ("moe_blocks.0.moe.w_down", (8, ff, d)): ff ** -0.5,
            ("moe_blocks.0.moe.router", (d, 64)): d ** -0.5,
            ("moe_blocks.0.moe.shared_w_gate", (d, 2 * ff)): d ** -0.5,
            ("moe_blocks.0.moe.shared_w_down", (2 * ff, d)): (2 * ff) ** -0.5,
            ("dense_blocks.0.mlp.w_down", (10944, d)): 10944 ** -0.5,
            ("moe_blocks.3.mla.wq", (d, 16, 192)): d ** -0.5,
            ("moe_blocks.3.mla.wkv_a", (d, 576)): d ** -0.5,
            ("moe_blocks.3.mla.wk_b", (512, 16, 128)): 512 ** -0.5,
            ("moe_blocks.3.mla.wv_b", (512, 16, 128)): 512 ** -0.5,
            ("moe_blocks.3.mla.wo", (16, 128, d)): (16 * 128) ** -0.5,
            ("lm_head", (d, 12800)): d ** -0.5,
            ("embed", (12800, d)): 1.0,
            ("moe_blocks.3.mla.kv_norm", (512,)): 0.0,
            ("moe_blocks.3.ln1.scale", (d,)): 0.0,
            ("final_norm.scale", (d,)): 0.0}
    for (name, shape), scale in want.items():
        assert fam.init_scale(name, shape, conf) == scale, name


def test_step_flops_by_hand():
    """A token's multiply-adds: attention 13,762,560 in each of the 27
    layers (wq 2048·16·192, wkv_a 2048·576, wk_b and wv_b 512·16·128,
    wo 16·128·2048), the dense layer's MLP 3·2048·10,944, in each of 26
    expert layers the shared experts 3·2048·2816, the router 2048·64 and
    0.75 of an expert's 3·2048·1408 (6 choices x 8 of 64 held), the head
    2048·12,800; six FLOPs each.  Attention's QK (192) and PV (128) over
    the 33,558,528 causal pairs of a row, 16 heads, 27 layers, three
    times the forward: 9.92 GFLOP a token, 325 TFLOP a 4 x 8192 step."""
    conf = registry.load_config("deepseek-v2-lite-ep8")
    fam = registry.load_family("moe")
    attn = 2048 * 16 * 192 + 2048 * 576 + 2 * 512 * 16 * 128 \
        + 16 * 128 * 2048
    assert attn == 13_762_560 == fam.attention_params(conf)
    per_token = (27 * attn + 3 * 2048 * 10944
                 + 26 * (3 * 2048 * 2816 + 2048 * 64
                         + 0.75 * 3 * 2048 * 1408) + 2048 * 12800)
    assert fam.matmul_params(conf) == per_token
    pairs = 8192 * 8193 // 2
    attn_flops = 3 * 2.0 * 27 * 16 * (192 + 128) * 4 * pairs
    step = fam.train_step_flops(conf, 4, 8192)
    assert step == 6 * per_token * 4 * 8192 + attn_flops
    assert step / (4 * 8192) == pytest.approx(9.92e9, rel=2e-3)
    assert step == pytest.approx(325e12, rel=2e-3)


def test_the_configuration_states_its_cut():
    conf = registry.load_config("deepseek-v2-lite-ep8")
    assert set(conf["reduced"]) == {"n_routed_experts", "vocab_size"}
    for key in conf["reduced"]:
        assert key in conf["published"]
    assert conf["published"] == {"n_routed_experts": 64,
                                 "vocab_size": 102400}
    assert conf["expert_share"] == {"router_experts": 64, "first_expert": 0}
    assert conf["vocab_size"] * 8 == conf["published"]["vocab_size"]
    assert conf["n_routed_experts"] * 8 == \
        conf["expert_share"]["router_experts"]
    cfg = registry.load_family("moe").model_config(conf)
    assert (cfg.num_layers, cfg.d_model, cfg.moe.num_experts,
            cfg.moe.top_k, cfg.routing.router_experts) == (27, 2048, 8, 6,
                                                           64)
    assert cfg.routing.dropless and not cfg.routing.renormalize
    assert cfg.mla.q_lora_rank == 0 and cfg.yarn.factor == 40
