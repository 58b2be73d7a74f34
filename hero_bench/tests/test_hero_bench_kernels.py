"""The port's kernels are files ``kernels/<label>.py``: their symbols
label a device trace's kernels, and a kernel the benchmark prices names
the attribute that launches it and the cost of a call, which the traced
run's shims record."""
import pytest
import torch

from hero_bench import costs, kernel_names, registry, tracing

# the table the labels were read from before the kernels had files
OLD_PORT = (
    ("K2-bwd", ("flash_bwd_prep", "flash_bwd_dkdv_wgmma",
                "flash_bwd_dq_wgmma", "flash_bwd_delta", "flash_bwd_dkdv",
                "flash_bwd_dq", "flash_bwd_sum")),
    ("K1", ("decode_attn", "decode_mla_wgmma", "decode_mla_combine",
            "decode_mla")),
    ("K2", ("flash_fwd_wgmma", "flash_combine", "flash_fwd",
            "flash_mla_wgmma", "flash_mla_combine", "flash_mla")),
    ("K3", ("topk_partial", "topk_merge")),
    ("K4", ("int8_mm_wgmma", "int8_mm")),
    ("K5", ("ssd_decode", "ssd_chunk_mma", "ssd_chunk_fwd")),
    ("K5-bwd", ("ssd_bwd_keys_mma", "ssd_bwd_queries_mma", "ssd_bwd_tiles",
                "ssd_bwd_finish")),
)


@pytest.mark.parametrize(
    "old_label,symbol",
    [(lab, s) for lab, syms in OLD_PORT for s in syms])
def test_every_old_symbol_keeps_its_label(old_label, symbol):
    # as the profiler names a templated kernel in an anonymous namespace
    name = f"void (anonymous namespace)::{symbol}<128, 128>(int)"
    assert kernel_names.label(symbol) == old_label
    assert kernel_names.label(name) == old_label


def test_the_files_hold_the_old_table():
    assert dict(kernel_names.table()) == dict(OLD_PORT)
    priced = {lab for lab, m in registry.load_kernels().items()
              if hasattr(m, "TARGET")}
    assert priced == {"K2", "K2-bwd"}


PLANTED = '''"""A kernel planted for the test, priced at one flop a query row."""
from hero_bench import costs

SYMBOLS = ("planted_gather",)
TARGET = ("repro_torch.kernels.ops", "flash_attention")


def cost(q, k, v, **kwargs):
    return costs.Cost(float(q.shape[1]), 0.0, "bfloat16")
'''


def test_a_planted_kernel_is_labelled_and_its_shim_records_its_cost(
        tmp_path):
    from repro_torch.kernels import ops
    root = tmp_path / "hero_bench"
    (root / "kernels").mkdir(parents=True)
    (root / "kernels" / "K9.py").write_text(PLANTED)
    assert kernel_names.label("void planted_gather<4>", root) == "K9"
    assert kernel_names.label("flash_fwd_wgmma", root) == "other"
    q = k = v = torch.randn(1, 6, 2, 16)
    orig = ops.flash_attention
    rec = tracing.Recorder()
    with tracing.kernel_shims(rec, root):
        rec.shapes_on = True
        out = ops.flash_attention(q, k, v, causal=True)
        rec.shapes_on = False
        ops.flash_attention(q, k, v, causal=True)    # not recorded
    assert ops.flash_attention is orig
    assert torch.equal(out, orig(q, k, v, causal=True))
    assert [(lab, c) for _, lab, c in rec.calls] == [
        ("K9", costs.Cost(6.0, 0.0, "bfloat16"))]


def test_k2_shim_prices_a_call_as_it_did():
    """K2's file prices a training forward's call with its LSE, from the
    call's own shapes and mask."""
    from repro_torch.kernels import ops
    q = torch.randn(2, 8, 4, 16, requires_grad=True)
    k = torch.randn(2, 10, 2, 16)
    v = torch.randn(2, 10, 2, 16)
    rec = tracing.Recorder()
    with tracing.kernel_shims(rec):
        rec.shapes_on = True
        ops.flash_attention(q, k, v, causal=True, q_offset=2)
    ((_, lab, c),) = rec.calls
    assert lab == "K2"
    assert c == costs.k2_forward(2, 8, 4, 2, 16, 16, 10, True, 2, 4,
                                 "float32", lse=True)


def test_k2_backward_prices_a_call_as_it_did():
    bwd = registry.load_kernels()["K2-bwd"]
    q = o = do = torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 12, 2, 16, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 8)
    got = bwd.cost(q, k, v, o, do, lse, causal=True, q_offset=4,
                   kv_len=None, scale=None)
    assert got == costs.k2_backward(1, 8, 4, 2, 16, 16, 12, True, 4, 2,
                                    "bfloat16")
