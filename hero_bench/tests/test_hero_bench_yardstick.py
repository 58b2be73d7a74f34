"""The yardstick on the CPU: the files load and agree with
BENCHMARK.json, traffic is a function of the seed, the counts of
operations and bytes match hand-worked numbers, rates are over the whole
window, and a dropped-in workload file is listed."""
import json
import re
import shutil

import pytest

from hero_bench import costs, kernel_names, registry, stats, traffic

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_agree(cell):
    wl = registry.load_workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"]
    assert wl["traffic"] == entry["traffic"]
    assert wl["chips"] == entry["chips"] == 1
    assert wl["why"] == entry["why"] and len(wl["why"]) <= 200
    conf = registry.load_config(wl["config"])
    assert conf["name"] == wl["config"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        mod = registry.load_metric(m["name"])
        assert mod.UNIT == m["unit"] and UNIT.match(m["unit"])
        assert mod.SOURCE == m["source"]
        assert NAME.match(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        if kind == "per_layer":
            moved = e2e[m["moves"]]
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


def test_benchmark_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("hero_bench/") and len(c["why"]) <= 200
        conf = registry.load_config(c["name"])
        assert conf.get("reduced", []) == c["reduced"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_config_states_its_cut():
    """Each configuration file names the keys it changed from its source,
    states each one's published value under ``published``, and names the
    deployment it stands for."""
    for c in BENCH["configs"]:
        conf = registry.load_config(c["name"])
        assert conf["source"] == c["source"]
        for key in conf["reduced"]:
            assert key in conf and key in conf["published"], key
        assert conf["deployment"]
        assert conf["dtype"] == "bfloat16"


def test_sample_is_a_function_of_the_seed():
    from hero_bench import check
    numels = {"a": 10, "b": 1 << 20}
    x, y = check.sample_indices(numels, 5), check.sample_indices(numels, 5)
    z = check.sample_indices(numels, 6)
    assert x["a"].tolist() == list(range(10))
    assert x["b"].equal(y["b"]) and not x["b"].equal(z["b"])
    assert len(x["b"]) == check.SAMPLE and int(x["b"].max()) < 1 << 20


def test_train_batches_differ_by_step_and_seed():
    import torch
    mix = {"batch": 2, "seq": 8}
    f = traffic.train_batches(mix, 3, 100, torch.device("cpu"))
    b0, b1 = next(f)["tokens"], next(f)["tokens"]
    g0 = next(traffic.train_batches(mix, 3, 100,
                                    torch.device("cpu")))["tokens"]
    h0 = next(traffic.train_batches(mix, 4, 100,
                                    torch.device("cpu")))["tokens"]
    assert torch.equal(b0, g0) and not torch.equal(b0, b1)
    assert not torch.equal(b0, h0)


def test_k2_counts_by_hand():
    # b=1, sq=4, h=2, n=1, e=ev=8, causal from 0: 1+2+3+4 = 10 pairs
    c = costs.k2_forward(1, 4, 2, 1, 8, 8, 4, True, 0, 2, "bfloat16")
    assert c.flops == 2 * 1 * 2 * 16 * 10
    assert c.nbytes == (4 * 2 * 8 * 2) * 2 + 4 * 1 * 16 * 2
    # with an offset of 2 over 6 keys: 3+4+5+6 = 18 pairs
    assert costs.visible_pairs(4, 6, True, 2) == 18


def test_k2_backward_counts_by_hand():
    c = costs.k2_backward(1, 4, 2, 1, 8, 8, 4, True, 0, 2, "bfloat16")
    assert c.flops == 2 * 2 * (3 * 8 + 2 * 8) * 10
    q = o = 4 * 2 * 8 * 2
    k = v = 4 * 1 * 8 * 2
    assert c.nbytes == 2 * (q + o + k + v) + 4 * 2 * 4


def test_dense_train_flops_by_hand():
    m = {"hidden_size": 4, "num_attention_heads": 2,
         "num_key_value_heads": 1, "head_dim": 2, "intermediate_size": 8,
         "vocab_size": 10, "num_hidden_layers": 3}
    dense = registry.load_family("dense")
    # a layer: q 4*2*2, k and v 4*1*2 each, o 2*2*4, mlp 3*4*8; head 4*10
    per_token = 3 * (16 + 16 + 16 + 96) + 40
    assert dense.matmul_params(m) == per_token
    # one row of 3 tokens: 6 causal pairs; QK and PV 2*2*(2+2) a pair a
    # layer in the forward, three times that in a step
    attn = 3 * 2.0 * 3 * 2 * 2 * 2 * 6
    assert dense.train_step_flops(m, 1, 3) == 6 * per_token * 3 + attn


def test_kernel_names():
    assert kernel_names.label("flash_bwd_dkdv_wgmma") == "K2-bwd"
    assert kernel_names.label("void flash_fwd_wgmma<1>") == "K2"
    assert kernel_names.label("decode_attn") == "K1"
    assert kernel_names.label("topk_partial") == "K3"
    assert kernel_names.label("sm90_xmma_gemm_bf16") == "gemm"
    assert kernel_names.label("vectorized_elementwise_kernel") == "other"


def test_rate_is_over_the_whole_window():
    assert stats.rate(100, 50.0) == 2.0
    from hero_bench.train import completed_steps
    # steps end at 1, 2, 3.5 s; a 3 s window holds two and a third
    assert completed_steps([1.0, 2.0, 3.5], 3.0) == pytest.approx(2 + 1 / 1.5)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_of_intervals():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(spans) == 4
    assert stats.gaps(spans, 0, 7) == [(3, 5), (6, 7)]
    assert stats.union_length([]) == 0


def test_a_dropped_in_workload_is_listed(tmp_path):
    root = tmp_path / "hero_bench"
    shutil.copytree(registry.HERE / "workloads", root / "workloads")
    before = registry.workload_names(root)
    wl = json.loads((root / "workloads" /
                     "qwen3-1.7b-train-4x4096.json").read_text())
    wl["mix"].update(batch=2, seq=8192)
    (root / "workloads" / "qwen3-1.7b-train-2x8192.json").write_text(
        json.dumps(wl))
    assert registry.workload_names(root) == sorted(
        before + ["qwen3-1.7b-train-2x8192"])
    got = registry.load_workload("qwen3-1.7b-train-2x8192", root)
    import torch
    batch = next(traffic.train_batches(got["mix"], 1, 1000,
                                       torch.device("cpu")))
    assert batch["tokens"].shape == (2, 8192)
