"""The split of a train step by the program's spans (``phases.py``), on a
synthetic trace: two steps inside a window [0, 10] and one cut by its
edge; the backward's kernels are launched from a second thread, as
autograd's device thread does; a block recomputed in the backward."""
import pytest

from hero_bench import phases, tracing
from hero_bench.phases import BACKWARD, BLOCK, FORWARD, OPTIMIZER, STEP

MAIN, AUTOGRAD = 1, 2


def _step(t0, spans, launches):
    """One step from ``t0``: forward [0, 1) with a block, backward [1, 2)
    with that block recomputed on the autograd thread, optimizer [2, 3).
    Launches (host time, device ms) are given as offsets from ``t0``."""
    spans += [(STEP, MAIN, t0, t0 + 3.0),
              (FORWARD, MAIN, t0, t0 + 1.0),
              (BLOCK, MAIN, t0 + 0.1, t0 + 0.6),
              (BACKWARD, MAIN, t0 + 1.0, t0 + 2.0),
              (BLOCK, AUTOGRAD, t0 + 1.2, t0 + 1.5),
              (OPTIMIZER, MAIN, t0 + 2.0, t0 + 2.9)]
    # (host offset, device ms): forward in a block and outside it, the
    # backward outside the recompute and inside it, the optimizer twice
    launches += [(t0 + dt, ms) for dt, ms in
                 ((0.2, 4.0), (0.8, 1.0), (1.1, 8.0), (1.3, 2.0),
                  (2.1, 0.5), (2.5, 0.25))]


def trace():
    spans, launches = [], []
    _step(-2.0, spans, launches)        # opens before the window
    _step(1.0, spans, launches)
    _step(5.0, spans, launches)
    _step(8.5, spans, launches)         # closes after it
    runtime, kernels, ids = [], [], []
    for i, (t, ms) in enumerate(launches):
        runtime.append(("cudaLaunchKernel" if i % 2 else "cuLaunchKernelEx",
                        100 + i, t, t + 1e-5))
        kernels.append((f"k{i}", t + 0.01, t + 0.01 + ms / 1e3))
        ids.append(100 + i)
    # a runtime call that launches nothing, and a copy's
    runtime.append(("cudaStreamSynchronize", 7, 2.5, 2.6))
    runtime.append(("cudaMemcpyAsync", 8, 2.05, 2.06))
    kernels.append(("Memcpy DtoD (Device -> Device)", 2.06, 2.06 + 3e-3))
    ids.append(8)
    return tracing.DeviceTrace(kernels, (0.0, 10.0), spans, runtime, ids)


def test_only_steps_inside_the_window_count():
    assert phases.complete_steps(trace()) == [(1.0, 4.0), (5.0, 8.0)]
    assert phases.split(trace())["steps"] == 2


def test_a_kernel_launched_from_another_thread_counts_in_the_backward():
    got = phases.split(trace())
    # 8 ms from the main thread's span, 2 ms launched on the autograd
    # thread, and the copy launched in the first step's backward
    assert got["backward_ms.train"] == pytest.approx(10.0 + 3.0 / 2)
    assert got["forward_ms.train"] == pytest.approx(5.0)
    assert got["optimizer_ms.train"] == pytest.approx(0.75)
    # by kernel label: the copy is neither a port kernel nor cuBLAS's
    assert got["phase_ms_by_kernel"]["backward"] == pytest.approx(
        {"other": 10.0 + 3.0 / 2})


def test_recompute_counts_only_blocks_inside_the_backward():
    got = phases.split(trace())
    assert got["recompute_ms.train"] == pytest.approx(2.0)
    assert got["recompute_ms.train"] <= got["backward_ms.train"]


def test_host_time_and_launches_a_step():
    got = phases.split(trace())
    assert got["forward_host_ms.train"] == pytest.approx(1e3)
    assert got["backward_host_ms.train"] == pytest.approx(1e3)
    assert got["optimizer_host_ms.train"] == pytest.approx(900.0)
    # six kernel launches a step; the copy and the sync are no launch
    assert got["launches.train"] == 6
    assert got["phase_share"] == pytest.approx(1.0)


def test_no_span_gives_nothing():
    """A program without spans (the benchmark laid over an older one)."""
    t = trace()
    t.spans = []
    assert phases.split(t) == {}


def test_idle_gaps_are_named_by_the_innermost_program_span():
    t = trace()
    host = [tracing.Span("train_step", 0.9, 4.1)]
    gaps = dict(phases.split(t, host)["idle_gaps"])
    # the recompute's block on the autograd thread is inside the backward
    # and shorter: a gap at its middle is the block's
    assert gaps["lm.block"] > 0
    assert gaps["train.optimizer"] > 0
    assert gaps["train.backward"] > 0


def test_span_names_are_the_programs():
    from repro_torch.core import spans
    assert {STEP, FORWARD, BACKWARD, OPTIMIZER, BLOCK} == spans.ALL_SPANS
    assert tracing.PREFIX == spans.PREFIX


def test_span_profiler_keeps_the_programs_spans():
    """On the CPU: a span opened inside the window comes back in
    ``tracing.Profiler``'s trace with its thread, on the window's clock;
    no kernel, so no correlation id."""
    from repro_torch.core.spans import SPAN_FORWARD, span
    prof = tracing.Profiler()
    prof.start()
    with span(SPAN_FORWARD):
        sum(range(1000))
    t = prof.stop()
    ((name, thread, s, e),) = t.spans
    assert name == SPAN_FORWARD
    assert t.window[0] <= s <= e <= t.window[1]
    assert isinstance(thread, int)
    assert t.kernels == [] and t.kernel_ids == []


def test_split_of_the_programs_steps_on_the_cpu():
    """Two steps of a reduced model under ``tracing.Profiler``: both complete
    in the window, each phase has host time; the CPU launches nothing."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.training import make_train_step
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              remat="dots")
    init, step = make_train_step(cfg, device="cpu")
    params, state = init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    prof = tracing.Profiler()
    prof.start()
    for _ in range(2):
        params, state, _ = step(params, state,
                                {"tokens": tokens, "labels": tokens})
    t = prof.stop()
    got = phases.split(t)
    assert got["steps"] == 2
    for short in ("forward", "backward", "optimizer"):
        assert got[f"{short}_host_ms.train"] > 0
        assert got[f"{short}_ms.train"] == 0
    assert got["launches.train"] == 0
    # remat "dots" recomputes each block of both steps in the backward
    assert len(phases.spans_in_steps(t, phases.BLOCK, within=phases.BACKWARD)
               ) == 2 * cfg.num_layers


SPAN_METRICS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
                "recompute_ms.train", "forward_host_ms.train",
                "backward_host_ms.train", "optimizer_host_ms.train",
                "launches.train")


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_reads_what_the_split_reads(name):
    from hero_bench import registry
    from hero_bench.report import RunView
    reader = registry.load_metric(name)
    assert reader.read(RunView(10.0, 0.0, trace=trace())) == \
        pytest.approx(phases.split(trace())[name])
    assert reader.read(RunView(10.0, 0.0)) is None          # untraced
    spanless = trace()
    spanless.spans = []
    assert reader.read(RunView(10.0, 0.0, trace=spanless)) is None


def test_a_planted_metric_reads_a_span_by_name(tmp_path):
    """A metric added as one file reads any of the program's spans."""
    from hero_bench import registry
    from hero_bench.report import RunView
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "block_ms.train.py").write_text(
        "from hero_bench import readers\n"
        "UNIT = 'ms'\n"
        "def read(run):\n"
        "    return readers.span_ms_per_step(run, 'repro_torch.lm.block')\n")
    got = registry.load_metric("block_ms.train", tmp_path).read(
        RunView(10.0, 0.0, trace=trace()))
    # a block in the forward (4 ms) and its recompute (2 ms) each step
    assert got == pytest.approx(6.0)
