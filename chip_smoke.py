#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never the JAX package) in phases; any
failure ends the run with a non-zero exit code and no result line:

1. build    — compile the seven CUDA libraries, K1-K5, K2's backward
              and K5's backward (one nvcc per source, in parallel);
              ptxas' registers, shared memory and spills of every
              kernel, the backwards' included.
1b. SASS    — the machine code of the redesigned kernels: K2's bf16
              kernel issues wgmma (HGMMA) and TMA loads (UTMALDG), K3's
              cp.async (LDGSTS), K1's 16-byte global loads (LDG.E.128)
              and cluster barriers (UCGABAR_ARV/UCGABAR_WAIT), K4's
              int8_mm_wgmma the integer wgmma (IGMMA) and TMA loads, K5's
              bf16 chunk kernel ssd_chunk_mma the tensor-core mma.sync
              (HMMA) and cp.async (LDGSTS), its ssd_decode 16-byte loads
              and stores (LDG.E.128, STG.E.128); K1's and K2's f32
              MLA-mode kernels cp.async, their bf16 decode_mla_wgmma and
              flash_mla_wgmma wgmma (HGMMA), TMA loads (UTMALDG) and the
              cluster barrier of the split merge (UCGABAR_ARV/WAIT);
              K2's bf16 backward kernels flash_bwd_dkdv_wgmma and
              flash_bwd_dq_wgmma wgmma (HGMMA) and TMA loads (UTMALDG);
              K5's bf16 backward kernels ssd_bwd_keys_mma and
              ssd_bwd_queries_mma mma.sync (HMMA) and cp.async (LDGSTS),
              with no spill in ptxas' report; K2's wgmma kernels at
              DeepSeek's naive widths (flash_fwd_wgmma<192,128>,
              flash_bwd_dkdv_wgmma<192,128>, flash_bwd_dq_wgmma<192,128>)
              built, issuing HGMMA and UTMALDG, with no spill.
2. kernels  — each kernel against its plain PyTorch version on the card at
              the main paths' full-width shapes, in bf16 and f32 (TF32 off),
              with its time, the plain version's and a library yardstick's:
              K1–K3 at the qwen3 / qwen1.5-0.5b shapes; K1 at the zamba2
              engine's (32 heads of 64, S in {64, 333, 923} cached
              positions of a 1024-slot cache) with every split count
              (cluster size) from 1 to 8, and ragged rows with a 0-length
              one inside an 8-block cluster; K2 in bf16 (the
              wgmma kernel) at e in {16, 64, 128} x g in {1, 2, 4}, at the
              zamba2 engine's shapes (split key range) and with kv_len < sk
              or 0; K3 over every split plan (nq in {1, 16}, N in {128,
              5000, 65536}, k in {8, 112, 131, 256}); K5 (SSD chunk) at
              zamba2's (64 heads, P = N = 64, one group) for the engine's
              seven chunk lengths Q in {1, 4, 60, 64, 72, 77, 128} (nc =
              1) and Q = 256 with nc in {1, 2}, with the plan's kernel and
              each kernel forced (ssd_decode where Q <= 32, ssd_chunk_mma
              in bf16, ssd_chunk_fwd), in bf16 (each timed) and f32, and
              Q in {1, 77, 128} with nc = 2 (checked, not timed); K4
              (int8 product, on no path) at the reference sweep's,
              the bench's (512³) and one zamba2 projection's shapes on
              int8_mm_wgmma (both timed), and a ragged shape on the __dp4a
              int8_mm.  K1 and K2 in window mode at zamba2-long's shapes
              (a 4096-slot ring, 32 heads of 64: K1 on a ring of 2000,
              4608 and 524288 positions, K2 with a 128-token chunk before,
              across and after the wrap) and at the cross shapes (whisper's
              1500 x 1500 encoder, cross prefill of 16 queries over 1500
              frames or 1601 patches, cross decode over them), each timed
              beside SDPA with an explicit boolean mask.  K1 and K2 in
              their MLA mode at deepseek-v2's shapes (128 heads over the
              576-wide latent rows, values their first 512 columns), in
              bf16 (timed beside SDPA with ``scale`` and ``enable_gqa``,
              and beside the mma.sync kernel it replaced, as PERF.md
              records it) and f32; K2 at the naive form's widths (q·k 192, v 128, n =
              h, the scale) on its generic route, 150 x 8 and 128 x 128
              heads.  K2's backward
              (``flash_attention_bwd``) against its plain version
              (``ref.flash_attention_bwd_ref``) from K2's own output and
              LSE (the LSE held to the plain one too), bf16 and f32: at
              the training shape (b 8, 256 positions, 16 heads of 64,
              causal), g in {2, 4, 8} at e 128, whisper's encoder (1500
              x 1500, 20 heads of 64) and a cross shape (16 queries over
              1601 keys, g 8, e 128) non-causal, kv_len < sk with a
              ragged sq, e 16, g 3 (63-row query tiles), and the naive MLA
              form (keys 192, values 128, the scale) at the moe train
              shape (b 2, 512 positions, 128 heads) and 150 x 8; bf16 (the
              wgmma kernels) timed beside ``torch.autograd.grad`` through
              SDPA (backward only), f32 on the CUDA-core kernels; two runs
              of each bit-equal.  K5's backward (``ssd_chunk_bwd``) with
              each route forced at every shape it takes (bf16 on both the
              tensor-core ssd_bwd_keys_mma + ssd_bwd_queries_mma and the
              CUDA-core ssd_bwd_tiles, f32 on ssd_bwd_tiles) at zamba2's
              widths (64 heads, P = N = 64, B and C one group broadcast
              to every head) for Q in {1, 77, 256} with nc in {1, 2} and
              at the train shape (b 4, nc 2, Q 256), and a group per head
              at narrower widths: dx, dB, dC against the plain version
              (``ref.ssd_chunk_bwd_ref``) at the input type's BWD_TOL,
              ddt and ddA against the plain version evaluated in f64 at
              f32's, every gradient finite, two runs bit-equal; bf16
              timed beside the plain version (no library call computes
              this function), both routes at the train shape, with the
              device time of each role's kernel (torch.profiler).
3. models   — the kernel path against the CPU plain path on a small input
              (same weights): the reduced qwen3 chat model, and a reduced
              f32 zamba2 (7 layers: one group, the shared block, one tail
              layer) through ``ServingEngine``; the same zamba2 at max_len
              40000, whose 4096-slot ring a 4200-token prompt wraps;
              reduced whisper and llama-3.2-vision with xgate at 0.5 and a
              seeded source (greedy ids equal, and a zero source moves the
              logits); a small f32 deepseek-v2 with its published MLA
              widths (8 heads) and a reduced xlstm-350m (4 layers, one
              sLSTM), greedy ids equal and deepseek's no-cache (naive)
              forward against its cached (absorbed) prefill; finite,
              well-shaped outputs of every RAG stage model at the
              published widths.  Training: one train step of reduced f32
              qwen1.5, whisper and xlstm on the card against the CPU
              plain path from the same weights (the loss and every
              gradient, none 0 on the card that is not on the CPU), then
              the losses of 3 AdamW steps, and the same for a reduced f32
              zamba2 (7 layers: a group, the shared block, a tail layer;
              K5's backward once a layer), a reduced llama-3.2-vision
              (xgate 0.5, K2 non-causal over the patches) and a small f32
              deepseek-v2 and v3 at their published MLA widths (K2 at
              192/128 and its backward once an attention block, v3's MTP
              block included); an absorbed-form MLA call under grad must
              raise the no-backward error (K2's MLA mode).
4. serve    — one isolated W2 query with straggler re-dispatch off (every
              stage runs once, so its launch counts are the query's own),
              then a ``--serve --spec-decode`` run of two staggered
              queries with it on, through ``repro_torch.launch.serve`` at the
              published qwen3 / qwen1.5-0.5b widths in bf16.  Each run
              starts with every launch counter at 0 and must finish every
              DAG node with no stage fn retried, no exception in any attempt
              (a cancelled straggler's included) and K1–K3 launched.  Then
              one speculative decode round, built by hand, runs through the
              served session's stage fns (the live run's rounds are the
              scheduler's choice, so it may form none).
   zamba2   — with the RAG models freed: a 300-token prefill of zamba2-1.2b
              at full width in bf16 gives finite logits, then
              ``ServingEngine`` serves six requests (prompts of 64 to 900
              tokens, 24 new tokens each, at most four at once) from
              counters at 0; every request must finish and K1, K2 and K5
              must have launched.
   zamba2 long — the same model through ``ServingEngine(max_len=524288)``
              (the long_500k length: a 4096-slot ring), one request of a
              4608-token prompt in chunks of 128 and 32 new tokens; K1 and
              K2 must have launched in window mode, K5 too.
   whisper, vlm — whisper-large-v3 whole and llama-3.2-vision-90b at
              every width and 10 of its 100 layers (bf16, xgate 0.5)
              through ``build_model``: a 16-token prefill with a seeded
              source (1500 frames, 1601 patch embeddings), then 24 greedy
              decode steps; K2 must have run non-causal (encoder, cross
              prefill) and K1 over the whole source.
   deepseek, xlstm — ``ServingEngine`` serves the zamba2 engine's six
              requests with deepseek-v2-236b (every width, 4 of its 60
              layers: the dense block and three MoE blocks of 160
              experts) or xlstm-350m (whole) in its place; every request
              must finish, and on deepseek K1 and K2 must have launched in
              their MLA mode.
   train    — qwen1.5-0.5b at its published width (24 layers, d 1024,
              16 heads of 64, d_ff 2816, vocab 151936, QKV bias, bf16,
              remat "dots") through ``repro_torch.training.train`` on
              ``launch.train.synthetic_data``: 12 AdamW steps on one
              fixed 8 x 256 batch at lr 1e-3 with a warm-up of 1 (the
              loss must fall by 0.5 or more; counters at 0 just before,
              read just after: K2's backward 24 launches a step, AdamW's
              kernel pair one call a step over every leaf), its
              median step time, tokens/s and peak memory; then 8 steps
              with an async checkpoint every 4 and a restart to 12 from
              the step-8 checkpoint, whose losses must match the
              uninterrupted run's within 2e-2; then 3 more steps under
              torch.profiler: the device time a step (the union of its
              kernels) beside the step wall, and K2's backward a launch.
   train hybrid — zamba2-1.2b at its published width (38 Mamba2 layers,
              d 2048, 64 SSD heads of P = N = 64, one group, chunks of
              256, the shared block after every 6 layers; bf16, remat
              "dots") the same way on one fixed 4 x 512 batch (two chunks
              a row): 12 AdamW steps, the loss down by 0.5 or more, a
              step's backward launches equal to the layer counts (K5's 38,
              K2's 6), the median step time, tokens/s and peak memory;
              then 3 profiled steps: the device time a step and K5's
              backward a launch.
   train moe — deepseek-v2-236b at every published width (d 5120, 128
              heads, MLA q_lora 1536 / kv_lora 512 / nope 128 / rope 64 /
              v 128, expert d_ff 1536, 2 shared, top-6, vocab 102400;
              bf16, remat "full"), cut to 2 of its 60 layers (first_k_dense
              + 1: one dense, one MoE) and 64 of its 160 routed experts,
              the same way on one fixed 2 x 512 batch: 12 AdamW steps, the
              loss down by 0.5 or more, K2's backward 2 launches a step,
              every K2 forward the naive form (192/128) on the generic
              route and none in MLA mode; the median step time, tokens/s
              and peak memory; then 3 profiled steps.
   document QA — ``examples/document_qa_torch.py --full-width``: W2 for
              two finqabench traces through a live ``HeroSession`` over the
              port's stage fns at the published qwen3 widths; both queries
              must finish every node, K1-K3 must launch.
   dry-run  — ``launch/op_cost.py`` counts qwen1.5-0.5b's train step at
              the train phase's shape on the card and on the meta device
              (the dry-run's mesh "1"): FLOPs, bytes and kernel calls must
              be equal; the counted FLOPs over the measured step time as a
              share of the card's bf16 peak.
5. timing   — each kernel, its plain version and the yardstick replayed at
              every shape the isolated W2 query, the zamba2 engine and
              long-context runs, the whisper and vlm runs, the deepseek
              engine and the train phases gave it, weighted by launches;
              K1's and K2's MLA mode as rows of their own; K2's and K5's
              backwards at the shapes the train phases gave them; AdamW's
              kernel pair at each train phase's leaf set (every width,
              its types), run with the plain loop from one state at step
              5: p, m and v bit-equal at the kernel's clip scale, the
              norm within rtol 1e-6; ``torch._fused_adamw_`` the yardstick.
   bench    — ``launch/kernels_bench.py``'s CSV rows at each path's most
              frequent shape of each kernel (its keys printed first),
              every kernel, backward and optimizer kernel among them.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.  Needs one GPU, no network.
"""
from __future__ import annotations

import collections
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # each kernel's cases (inputs, plain version, library call, bound),
    # limits and timing, shared with the port's kernel bench
    from repro_torch.launch.kernels_bench import (
        BWD_TOL, MLA_ROW, MLA_SCALE, REPLAY, SSD_BWD_NAMES, SSD_TOL,
        RingFill, backward_case, bound_ms, decode_case, flash_case, fmt,
        int8_case, is_mla_key, measure, mla_decode_case, mla_flash_case,
        ssd_backward_case, ssd_case, timed, topk_case)
except ModuleNotFoundError:
    sys.exit(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
             f"from a checkout of the repository")
# the kernels of each main path; every one must launch on its path
RAG_PATH = ("decode_attention", "flash_attention", "topk_retrieval")
ENGINE_PATH = ("decode_attention", "flash_attention", "ssd_chunk")
# K2's wgmma kernels at DeepSeek's naive MLA widths (keys 192, values 128),
# by library, as ptxas and cuobjdump name them
NAIVE_WGMMA = {"flash_attention": ("flash_fwd_wgmma<192,128>",),
               "flash_attention_bwd": ("flash_bwd_dkdv_wgmma<192,128>",
                                       "flash_bwd_dq_wgmma<192,128>")}
# a reduced f32 train step on the card against the CPU plain path: the
# parity tolerance of tests/test_torch_training.py (atol, rtol); the
# losses of 3 AdamW steps within TRAIN_LOSS_TOL relative
TRAIN_TOL = (2e-5, 1e-4)
TRAIN_LOSS_TOL = 1e-4
# the train phase (profile_serve's TRAIN_ARCH at TRAIN_BATCH x TRAIN_SEQ):
# the bar of test_loss_decreases_on_fixed_batch over 12 steps, and the
# restart's limit against the uninterrupted run (the embedding's backward
# sums with atomics on the card, so two runs are not bit-equal)
TRAIN_STEPS, TRAIN_DROP, RESTART_TOL = 12, 0.5, 2e-2


# K1's and K2's bf16 MLA mode at check_mla's shapes: us a call of the
# mma.sync kernels that decode_mla_wgmma and flash_mla_wgmma replaced
# (decode_mla_mma, flash_mla_mma), as PERF.md §6 records them: mla_sweep.py
# on the parent tree, the mean of two runs taken in turns with the new
# kernels in one call (NVIDIA H100 80GB HBM3, 700 W); printed beside each
# new time
MLA_MMA_US = {
    "decode_attention MLA 128 heads S=64": 18.46,
    "decode_attention MLA 128 heads S=333": 22.32,
    "decode_attention MLA 128 heads S=923": 27.87,
    "decode_attention MLA S=923 no split": 138.43,
    "decode_attention MLA ragged [300,77,0]": 21.22,
    "flash_attention MLA absorbed sq=128 q_offset=0": 53.15,
    "flash_attention MLA absorbed sq=128 q_offset=384": 154.11,
    "flash_attention MLA absorbed sq=128 q_offset=772": 258.08,
    "flash_attention MLA absorbed sq=77 q_offset=256": 108.82,
    "flash_attention MLA absorbed sq=5 q_offset=0": 17.66}


def say(*a):
    print(*a, flush=True)




def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(got, want, tol, what):
    """|got - want| <= atol + rtol * |want| elementwise (numpy's allclose;
    ``tol`` is atol = rtol, as tests/test_kernels.py, or an (atol, rtol)
    pair); -> max |err|."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    got, want = got.float(), want.float()
    bad = (got - want).abs() > atol + rtol * want.abs()
    err = max_err(got, want)
    assert not bool(bad.any()), (f"{what}: max|err| {err:.3e} over "
                                 f"{tol_str(tol)}")
    return err


def check_scaled(got, want, tol, what):
    """check_close with atol = tol[0] · max |want| (a gradient's scale
    varies with the shape) and rtol = tol[1]."""
    scale = float(want.float().abs().max())
    return check_close(got, want, (tol[0] * scale, tol[1]), what)


def tol_str(tol):
    if isinstance(tol, tuple):
        return f"{tol[0]:.0e} + {tol[1]:.0e}·|want|"
    return f"{tol:.0e}"





def check_case(case, what):
    """The kernel against its plain version (and, where the case has one,
    against its near-exact version), or against what the case's ``want``
    gives; -> max |err| (over every output of a pair)."""
    if "check" in case:                 # the case's own (AdamW's, bitwise)
        return case["check"]()
    got, want = case["kernel"](), case.get("want", case["plain"])()
    if "exact" in case:
        check_close(got, case["exact"](), case["exact_tol"],
                    f"{what} against the near-exact version")
    if not case.get("pair"):
        got, want = (got,), (want,)
    if "tols" in case:
        check = check_scaled if case.get("scaled") else check_close
        return max(check(a, b, tol, what)
                   for a, b, tol in zip(got, want, case["tols"]))
    if case.get("scaled"):
        return max(check_scaled(a, b, case["tol"], what)
                   for a, b in zip(got, want))
    return max(check_close(a, b, case["tol"], what)
               for a, b in zip(got, want))


def check_topk(case, exact_ids):
    """Values to 1e-4.  Ids equal; with ``exact_ids`` False a differing id
    is allowed only inside a near-tie (plain scores within 1e-5), since the
    kernel and the plain product sum in other orders."""
    (gv, gi), (wv, wi) = case["kernel"](), case["plain"]()
    err = max_err(gv, wv)
    assert err <= 1e-4, f"top-k values off by {err}"
    diff = gi != wi
    if exact_ids:
        assert not bool(diff.any()), "top-k ids differ"
    elif bool(diff.any()):
        s = case["scores"]().double()
        gap = (s.gather(1, gi.long()) - s.gather(1, wi.long())).abs()[diff]
        assert float(gap.max()) <= 1e-5, f"top-k ids differ (gap {gap.max()})"
    assert all(len(set(r)) == len(r) for r in gi.tolist()), "duplicate ids"
    return err, int(diff.sum())



# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build, ops
    t0 = time.monotonic()
    took = _build.build(k.name for k in (*ops.KERNELS, *ops.BACKWARD_KERNELS,
                                         *ops.OPTIMIZER_KERNELS))
    say(f"[build] {len(took)} libraries in {time.monotonic() - t0:.1f}s "
        f"(nvcc {_build.nvcc()})")
    # the machine code of the redesigned kernels: wgmma (HGMMA) and TMA
    # loads (UTMALDG) in K2's bf16 kernel, cp.async (LDGSTS) in K3's;
    # 16-byte loads (LDG.E.128) and the cluster barrier of the split merge
    # (UCGABAR_ARV/WAIT) in K1's; the integer wgmma (IGMMA) and TMA loads
    # in K4's int8_mm_wgmma; the tensor-core mma.sync (HMMA) and cp.async
    # in K5's ssd_chunk_mma, 16-byte loads and stores in its ssd_decode;
    # cp.async in K1's and K2's f32 MLA mode (decode_mla, flash_mla); in
    # their bf16 decode_mla_wgmma and flash_mla_wgmma wgmma, TMA loads and
    # the cluster barrier of the split merge; wgmma and TMA loads in K2's
    # bf16 backward kernels; mma.sync and cp.async in K5's bf16 backward
    # kernels.  Each named kernel must issue each opcode.
    must = {"flash_fwd_wgmma": ("HGMMA", "UTMALDG"),
            "topk_partial": ("LDGSTS",),
            "decode_attn": ("LDG.E.128", "UCGABAR_ARV", "UCGABAR_WAIT"),
            "int8_mm_wgmma": ("IGMMA", "UTMALDG"),
            "ssd_chunk_mma": ("HMMA", "LDGSTS"),
            "ssd_decode": ("LDG.E.128", "STG.E.128"),
            "decode_mla": ("LDGSTS",), "flash_mla": ("LDGSTS",),
            "flash_mla_wgmma": ("HGMMA", "UTMALDG", "UCGABAR_ARV",
                                "UCGABAR_WAIT"),
            "decode_mla_wgmma": ("HGMMA", "UTMALDG", "UCGABAR_ARV",
                                 "UCGABAR_WAIT"),
            "flash_bwd_dkdv_wgmma": ("HGMMA", "UTMALDG"),
            "flash_bwd_dq_wgmma": ("HGMMA", "UTMALDG"),
            "ssd_bwd_keys_mma": ("HMMA", "LDGSTS"),
            "ssd_bwd_queries_mma": ("HMMA", "LDGSTS")}
    for name, opcodes in (("flash_attention", ("HGMMA", "UTMALDG",
                                               "LDGSTS", "UCGABAR_ARV",
                                               "UCGABAR_WAIT")),
                          ("topk_retrieval", ("LDGSTS",)),
                          ("decode_attention", ("LDG.E.128", "UCGABAR_ARV",
                                                "UCGABAR_WAIT", "LDGSTS",
                                                "HGMMA", "UTMALDG")),
                          ("int8_matmul", ("IGMMA", "UTMALDG")),
                          ("ssd_chunk", ("HMMA", "LDGSTS", "LDG.E.128",
                                         "STG.E.128")),
                          ("flash_attention_bwd", ("HGMMA", "UTMALDG")),
                          ("ssd_chunk_bwd", ("HMMA", "LDGSTS"))):
        counts = _build.sass_counts(name, opcodes)
        say(f"[build] {name} SASS: " + " | ".join(
            f"{fn}: " + ", ".join(f"{c} {op}" for op, c in ops_.items())
            for fn, ops_ in sorted(counts.items())))
        for fn, v in counts.items():
            for op in must.get(fn.split("<")[0], ()):
                assert v[op] > 0, f"{fn} issues no {op}: {counts}"
        assert any(fn.split("<")[0] in must for fn in counts), counts
        for fn in NAIVE_WGMMA.get(name, ()):    # (192, 128): HGMMA, UTMALDG
            assert fn in counts, (fn, sorted(counts))
    # K5's tensor-core backward keeps its fragments in registers: a spill
    # would put them in local memory (ptxas' report, kept with the library)
    mma_bwd = [ln for ln in _build.report("ssd_chunk_bwd")
               if "_mma" in ln.split(":")[0]]
    assert {ln.split(":")[0] for ln in mma_bwd} == {
        "ssd_bwd_keys_mma", "ssd_bwd_queries_mma"}, mma_bwd
    for ln in mma_bwd:
        assert "spill" not in ln, f"ptxas spills: {ln}"
    # so do K2's wgmma kernels at DeepSeek's naive widths, where the dK/dV
    # pass splits its 64 keys' accumulators over two warpgroups
    for name, fns in NAIVE_WGMMA.items():
        lines = {ln.split(":")[0]: ln for ln in _build.report(name)}
        for fn in fns:
            assert fn in lines, (fn, sorted(lines))
            assert "spill" not in lines[fn], f"ptxas spills: {lines[fn]}"
            say(f"[build] no spill: {lines[fn]}")


def phase_kernels():
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = collections.defaultdict(float)
    say("[kernels] TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    # the floor under every time below: an empty kernel, timed as they are
    floor = timed(lambda: torch.cuda._sleep(0))[0]
    say(f"[kernels] launch floor: an empty kernel (torch.cuda._sleep(0)) "
        f"times {1e3 * floor:.2f} us back to back")
    # K1: qwen3 embed/rerank/search (g=2), qwen3-4b chat (g=4), draft (g=1)
    for (h, n, e), who in (((16, 8, 128), "qwen3 g=2"),
                           ((32, 8, 128), "qwen3-4b g=4"),
                           ((16, 16, 64), "qwen1.5-0.5b g=1")):
        for S in (256, 512):
            for b in (1, 8):
                for dt in (torch.bfloat16, torch.float32):
                    c = decode_case(b, h, n, S, e, dt, g)
                    err = check_close(c["kernel"](), c["plain"](), c["tol"],
                                      f"decode {who} b={b} S={S} {dt}")
                    if dt == torch.bfloat16:
                        errs["decode_attention"] = max(
                            errs["decode_attention"], err)
                    line = (f"[kernels] decode_attention {who} b={b} S={S} "
                            f"{str(dt)[6:]}: max|err| {err:.2e} <= "
                            f"{tol_str(c['tol'])}")
                    if dt == torch.bfloat16:
                        line += " | " + fmt(measure(c))
                    say(line)
    c = decode_case(3, 32, 8, 300, 128, torch.bfloat16, g,
                    lengths=[300, 77, 0])
    err = check_close(c["kernel"](), c["plain"](), c["tol"],
                      "decode ragged lengths")
    say(f"[kernels] decode_attention ragged lengths [300,77,0]: "
        f"max|err| {err:.2e}")
    # K1 at the zamba2 engine's shapes: 32 heads of 64 (g = 1), b = 1, S
    # cached positions of a 1024-slot cache; the plan's split count timed
    # against the plain version and SDPA, then every cluster size from 1
    # to 8 (a launch with nsplit > 1 fails unless its cluster formed: the
    # kernel traps on %cluster_nctarank != nsplit)
    from repro_torch.kernels import decode_attention as k1
    for S in (64, 333, 923):
        plan = k1.split_plan(1, 32, 32, S, 64)
        for dt in (torch.bfloat16, torch.float32):
            c = decode_case(1, 32, 32, S, 64, dt, g, slots=1024)
            err = check_close(c["kernel"](), c["plain"](), c["tol"],
                              f"decode engine S={S} {dt}")
            if dt == torch.bfloat16:
                errs["decode_attention"] = max(errs["decode_attention"], err)
            line = (f"[kernels] decode_attention zamba2 engine S={S} "
                    f"{str(dt)[6:]} (plan {plan}): max|err| {err:.2e} <= "
                    f"{tol_str(c['tol'])}")
            if dt == torch.bfloat16:
                line += " | " + fmt(measure(c))
            say(line)
        per_split = []
        for ns in range(1, k1.MAX_SPLIT + 1):
            for dt in (torch.bfloat16, torch.float32):
                c = decode_case(1, 32, 32, S, 64, dt, g, nsplit=ns,
                                slots=1024)
                check_close(c["kernel"](), c["plain"](), c["tol"],
                            f"decode engine S={S} nsplit={ns} {dt}")
                if dt == torch.bfloat16:
                    per_split.append(f"{ns}: {1e3 * timed(c['kernel'])[0]:.1f}")
        say(f"[kernels] decode_attention zamba2 engine S={S}, every split "
            f"count 1-8 in bf16 and f32 within tolerance; bf16 kernel us by "
            f"split count: " + ", ".join(per_split))
    for dt in (torch.bfloat16, torch.float32):
        c = decode_case(3, 32, 32, 500, 64, dt, g, lengths=[500, 0, 130],
                        nsplit=8, slots=1024)
        got = c["kernel"]()
        err = check_close(got, c["plain"](), c["tol"],
                          f"decode ragged cluster {dt}")
        assert float(got[1].float().abs().max()) == 0.0, "0-length row not 0"
        say(f"[kernels] decode_attention ragged rows [500,0,130] in 8-block "
            f"clusters {str(dt)[6:]}: max|err| {err:.2e}, the 0-length row "
            f"outputs 0")
    # K2: causal prefill / embed / rerank lengths, one prefill at an offset
    for (h, n), who in (((16, 8), "qwen3 g=2"), ((32, 8), "qwen3-4b g=4")):
        for sq, sk, off in ((16, 16, 0), (128, 128, 0), (192, 192, 0),
                            (16, 48, 32)):
            for dt in (torch.bfloat16, torch.float32):
                b = 8 if sq >= 128 else 1
                c = flash_case(b, sq, h, sk, n, 128, dt, g, q_offset=off)
                err = check_close(c["kernel"](), c["plain"](), c["tol"],
                                  f"flash {who} sq={sq} {dt}")
                if dt == torch.bfloat16:
                    errs["flash_attention"] = max(errs["flash_attention"],
                                                  err)
                line = (f"[kernels] flash_attention {who} b={b} sq={sq} "
                        f"sk={sk} q_offset={off} {str(dt)[6:]}: max|err| "
                        f"{err:.2e} <= {tol_str(c['tol'])}")
                if dt == torch.bfloat16:
                    line += " | " + fmt(measure(c))
                say(line)
    # K2 in bf16 runs flash_fwd_wgmma: every head dim with GQA groups of 1,
    # 2 and 4, sq not a multiple of 64; the zamba2 engine's shape (32 heads
    # of 64, b = 1, chunked prefill at offsets up to 896: the key range is
    # split across blocks and combined), timed; kv_len < sk; kv_len = 0
    from repro_torch.kernels import flash_attention as k2
    assert k2.kernel_for(torch.bfloat16) == "flash_fwd_wgmma"
    assert k2.kernel_for(torch.float32) == "flash_fwd"
    cases = [(b, sq, 8 * gq, e, causal) for e in (16, 64, 128)
             for gq in (1, 2, 4)
             for b, sq, causal in ((2, 77, True), (1, 72, False))]
    for b, sq, h, e, causal in cases:
        c = flash_case(b, sq, h, sq + (0 if causal else 28), 8, e,
                       torch.bfloat16, g, causal=causal)
        err = check_close(c["kernel"](), c["plain"](), c["tol"],
                          f"flash wgmma e={e} h={h} sq={sq}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    say(f"[kernels] flash_attention bf16 (flash_fwd_wgmma) e in (16, 64, "
        f"128) x g in (1, 2, 4), sq 77 causal / 72 not: {len(cases)} cases "
        f"within 2e-02")
    for sq, sk, off in ((128, 128, 0), (77, 333, 256), (128, 1024, 896),
                        (60, 700, 640)):
        c = flash_case(1, sq, 32, sk, 32, 64, torch.bfloat16, g,
                       q_offset=off)
        err = check_close(c["kernel"](), c["plain"](), c["tol"],
                          f"flash engine sq={sq} q_offset={off}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        plan = k2.plan(1, sq, 32, 32, sk, True, off)
        say(f"[kernels] flash_attention zamba2 engine b=1 sq={sq} sk={sk} "
            f"q_offset={off} bf16 (plan {plan}): max|err| {err:.2e} <= "
            f"2e-02 | " + fmt(measure(c)))
    for b, sq, h, n, sk, e, off, kv_len, causal in (
            (2, 16, 8, 4, 64, 64, 24, 40, True),
            (1, 8, 8, 4, 32, 128, 0, 0, False)):
        c = flash_case(b, sq, h, sk, n, e, torch.bfloat16, g,
                       causal=causal, q_offset=off, kv_len=kv_len)
        got = c["kernel"]()
        err = check_close(got, c["plain"](), c["tol"],
                          f"flash kv_len={kv_len}")
        if kv_len == 0:
            assert float(got.float().abs().max()) == 0.0, "masked row not 0"
        say(f"[kernels] flash_attention bf16 kv_len={kv_len} < sk={sk}: "
            f"max|err| {err:.2e}" + (", every row fully masked: output 0"
                                     if kv_len == 0 else ""))
    # K3: every split plan (nq in {1, 16}, N in {128, 5000, 65536}, k in
    # {8, 112, 131, 256}); the path's tiny corpus and a full VectorDB
    # capacity timed; exact ties below
    from repro_torch.kernels import topk_retrieval as k3
    timed_k3 = {(1, 128, 112), (16, 65536, 8), (16, 65536, 131),
                (1, 65536, 8)}
    for nq in (1, 16):
        for N in (128, 5000, 65536):
            for k in (8, 112, 131, 256):
                if k > N:
                    continue
                c = topk_case(nq, N, 1024, k, g)
                err, flips = check_topk(c, exact_ids=False)
                errs["topk_retrieval"] = max(errs["topk_retrieval"], err)
                line = (f"[kernels] topk_retrieval nq={nq} N={N} d=1024 "
                        f"k={k} (plan {k3.split_plan(nq, N, k)}): max|err| "
                        f"{err:.2e} <= 1e-04, {flips} ids swapped inside "
                        f"near-ties")
                if (nq, N, k) in timed_k3:
                    line += " | " + fmt(measure(c))
                say(line)
    # multiples of 1/8 with |x| <= 2/8: every score is exact in f32 in any
    # order of summation, so ties are true ties and ids must match exactly
    ints = torch.randint(-2, 3, (4104, 64), generator=g, device="cuda")
    c = topk_case(8, 4096, 64, 256, g, queries=ints[:8].float() / 8,
                  corpus=ints[8:].float() / 8)
    err, _ = check_topk(c, exact_ids=True)
    ints = torch.randint(-2, 3, (65552, 64), generator=g, device="cuda")
    for nq, N, k in ((1, 128, 112), (16, 5000, 8), (16, 65536, 131)):
        c = topk_case(nq, N, 64, k, g, queries=ints[:nq].float() / 8,
                      corpus=ints[16:16 + N].float() / 8)
        check_topk(c, exact_ids=True)
    say(f"[kernels] topk_retrieval exact scores with ties (k=256 of 4096; "
        f"112 of 128; 8 of 5000; 131 of 65536): ids equal, max|err| "
        f"{err:.2e}")
    # K5: zamba2-1.2b, 64 heads, P = N = 64, one group: the engine's chunk
    # lengths (decode Q = 1, a 4-token tail, the last prefill chunks of
    # 700/512/200/333-token prompts, full 128-token chunks) and a 300-token
    # prefill padded to nc = 2 chunks of 256, timed in bf16; two chunks at
    # 1, 77 and 128, checked.  The plan's kernel, then each kernel forced
    # (ssd_chunk_fwd is the port's first K5, unchanged).  ssd_sweep.py
    # measures the plan's threshold and slice counts.
    from repro_torch.kernels import ssd_chunk as k5
    engine = ((1, 1), (4, 1), (60, 1), (64, 1), (72, 1), (77, 1), (128, 1),
              (256, 1), (256, 2))
    for Q, nc in engine + ((1, 2), (77, 2), (128, 2)):
        for dt in (torch.bfloat16, torch.float32):
            timing = dt == torch.bfloat16 and (Q, nc) in engine
            plan = k5.plan(1, nc, Q, 64, 64, 64, dt)
            c = ssd_case(1, nc, Q, 64, 64, 64, dt, True, g)
            err = check_case(c, f"ssd_chunk Q={Q} nc={nc} {dt}")
            errs["ssd_chunk"] = max(errs["ssd_chunk"], err)
            line = (f"[kernels] ssd_chunk zamba2 Q={Q} nc={nc} {str(dt)[6:]} "
                    f"({plan.kernel}, splits {plan.splits}): max|err| "
                    f"{err:.2e} <= {SSD_TOL:.0e}")
            if timing:
                line += " | " + fmt(measure(c))
            forced = []
            for kern in ("ssd_decode", "ssd_chunk_mma", "ssd_chunk_fwd"):
                if ((kern == "ssd_decode" and Q > k5.DECODE_LIMIT_Q)
                        or (kern == "ssd_chunk_mma" and dt != torch.bfloat16)):
                    continue
                c = ssd_case(1, nc, Q, 64, 64, 64, dt, True, g, kernel=kern)
                err = check_case(c, f"ssd_chunk {kern} Q={Q} nc={nc} {dt}")
                errs["ssd_chunk"] = max(errs["ssd_chunk"], err)
                if timing:
                    forced.append(f"{kern} {1e3 * timed(c['kernel'])[0]:.1f}")
            say(line)
            if forced:
                say(f"[kernels] ssd_chunk zamba2 Q={Q} nc={nc} bf16, each "
                    f"kernel forced (within {SSD_TOL:.0e}), us: "
                    + ", ".join(forced))
    c = ssd_case(2, 3, 32, 4, 16, 8, torch.float32, False, g)
    err = check_case(c, "ssd_chunk one group per head")
    say(f"[kernels] ssd_chunk b=2 nc=3 Q=32 H=4 P=16 N=8, a group per head: "
        f"max|err| {err:.2e}")
    # K4, on no path: the reference sweep, the bench's shape (512³), a
    # zamba2 projection (its row of the kernel table is timed at the
    # last), all on int8_mm_wgmma; a ragged shape on the __dp4a int8_mm
    from repro_torch.kernels import int8_matmul as k4
    k4_time = None
    for M, K, N in ((128, 256, 192), (64, 64, 64), (256, 128, 512),
                    (77, 100, 33), (512, 512, 512), (128, 2048, 4096)):
        fn = k4.kernel_for(M, N, K)
        assert fn == ("int8_mm" if (M, K, N) == (77, 100, 33)
                      else "int8_mm_wgmma"), fn
        for dt in (torch.bfloat16, torch.float32):
            c = int8_case(M, K, N, dt, g)
            err = check_case(c, f"int8_matmul {M}x{K}x{N} {dt}")
            errs["int8_matmul"] = max(errs["int8_matmul"], err)
            line = (f"[kernels] int8_matmul ({fn}) M={M} K={K} N={N} -> "
                    f"{str(dt)[6:]}: equal to the plain version "
                    f"(max|err| {err:.1e})")
            if dt == torch.bfloat16 and M * K * N >= 512 ** 3:
                k4_time = measure(c)
                line += (" | " + fmt(k4_time)
                         + " (library: _int_mm, no epilogue)")
            say(line)
    check_window_and_cross(g, errs)
    check_mla(g, errs)
    check_backward(g, errs)
    check_ssd_backward(g, errs)
    return errs, k4_time


def check_window_and_cross(g, errs):
    """K1/K2's window mode at zamba2-long's shapes (a 4096-slot ring, 32
    heads of 64, b = 1) and their cross-attention shapes (whisper-large-v3:
    1500 frames, 20 heads of 64; llama-3.2-vision: 1601 patches, 64 heads
    over 8 kv heads of 128), each against its plain version in bf16 (timed,
    beside SDPA with an explicit boolean ``attn_mask`` and ``enable_gqa``)
    and f32.  Every row of these calls sees at least MANY_KEYS keys, so
    bf16 is held to MANY_KEYS_TOL; a window of 256 of the 4096 slots makes
    a key at the window's edge weigh 1/256 of its row."""
    cases = []
    # K1, one new token over the ring: not yet full, full and wrapped; a
    # narrow window
    for end, window in ((2000, 4096), (4608, 4096), (524288, 4096),
                        (524288, 256)):
        cases.append((f"decode_attention window={window} W=4096 ring of "
                      f"{end} positions", "decode_attention",
                      lambda dt, end=end, window=window: decode_case(
                          1, 32, 32, 4096, 64, dt, g, window=window,
                          ring_end=end)))
    # K2, a 128-token prefill chunk over the ring: before the wrap, across
    # it, wrapped; a narrow window
    for off, window in ((1920, 4096), (4000, 4096), (4480, 4096),
                        (4480, 256)):
        cases.append((f"flash_attention window={window} sq=128 over 4096 "
                      f"slots q_offset={off}", "flash_attention",
                      lambda dt, off=off, window=window: flash_case(
                          1, 128, 32, 4096, 32, 64, dt, g, q_offset=off,
                          window=window)))
    # cross shapes: whisper's encoder, then cross prefill and decode
    cases += [
        ("flash_attention whisper encoder 1500x1500 non-causal",
         "flash_attention", lambda dt: flash_case(
             1, 1500, 20, 1500, 20, 64, dt, g, causal=False)),
        ("flash_attention whisper cross prefill sq=16 sk=1500",
         "flash_attention", lambda dt: flash_case(
             1, 16, 20, 1500, 20, 64, dt, g, causal=False)),
        ("flash_attention vlm cross prefill sq=16 sk=1601 g=8 e=128",
         "flash_attention", lambda dt: flash_case(
             1, 16, 64, 1601, 8, 128, dt, g, causal=False)),
        ("decode_attention whisper cross S=1500", "decode_attention",
         lambda dt: decode_case(1, 20, 20, 1500, 64, dt, g)),
        ("decode_attention vlm cross S=1601 g=8 e=128", "decode_attention",
         lambda dt: decode_case(1, 64, 8, 1601, 128, dt, g)),
    ]
    for what, name, make in cases:
        for dt in (torch.bfloat16, torch.float32):
            c = make(dt)
            err = check_close(c["kernel"](), c["plain"](), c["tol"],
                              f"{what} {dt}")
            line = (f"[kernels] {what} {str(dt)[6:]}: max|err| {err:.2e} "
                    f"<= {tol_str(c['tol'])}")
            if dt == torch.bfloat16:
                errs[name] = max(errs[name], err)
                line += " | " + fmt(measure(c))
            say(line)


def check_mla(g, errs):
    """K1's and K2's MLA mode at deepseek-v2's shapes (b = 1, 128 heads,
    scale 1/sqrt(192)): K1 over 64 / 333 / 923 latent rows of a 1024-row
    cache (the engine's decode), with the plan's split, no split and
    ragged rows; K2 absorbed for the engine's prefill chunks (128 queries
    at 0, 384 and 772, 77 at 256) and a 5-token first chunk.  bf16 timed
    beside SDPA, f32 checked.  Then the naive form (the forward without a
    cache: keys 192, values 128, n = h) at 150 positions of 8 heads and
    128 of 128 heads, which runs K2's generic route (flash_fwd_wgmma in
    bf16, flash_fwd in f32), held to the plain version as every K2 call
    there is, bf16 timed beside SDPA with ``scale``."""
    from repro_torch.kernels import flash_attention as k2
    cases = []
    for S in (64, 333, 923):
        cases.append((f"decode_attention MLA 128 heads S={S}",
                      lambda dt, S=S: mla_decode_case(1, 128, S, dt, g,
                                                      slots=1024)))
    cases += [
        ("decode_attention MLA S=923 no split", lambda dt: mla_decode_case(
            1, 128, 923, dt, g, nsplit=1, slots=1024)),
        ("decode_attention MLA ragged [300,77,0]",
         lambda dt: mla_decode_case(3, 128, 300, dt, g,
                                    lengths=[300, 77, 0]))]
    for sq, off in ((128, 0), (128, 384), (128, 772), (77, 256), (5, 0)):
        cases.append((f"flash_attention MLA absorbed sq={sq} q_offset={off}",
                      lambda dt, sq=sq, off=off: mla_flash_case(
                          1, sq, 128, off + sq, 1, 576, 512, dt, g,
                          q_offset=off)))
    for what, make in cases:
        name = MLA_ROW[what.split()[0]]
        for dt in (torch.bfloat16, torch.float32):
            c = make(dt)
            got, want, exact = c["kernel"](), c["plain"](), c["exact"]()
            err = check_close(got, want, c["tol"], f"{what} {dt}")
            xerr = check_close(got, exact, c["exact_tol"],
                               f"{what} {dt} against the near-exact version")
            errs[name] = max(errs[name], err)
            line = (f"[kernels] {what} {str(dt)[6:]}: max|err| {err:.2e} "
                    f"<= {tol_str(c['tol'])}; from the near-exact version: "
                    f"kernel {xerr:.2e} <= {tol_str(c['exact_tol'])}, plain "
                    f"{max_err(want, exact):.2e}")
            if dt == torch.bfloat16:
                t = measure(c)
                line += " | " + fmt(t)
                was = MLA_MMA_US.get(what)
                line += (" | the mma.sync kernel it replaced: not measured"
                         if was is None else
                         f" | the mma.sync kernel it replaced {was:.2f} us,"
                         f" now {was / (1e3 * t['ms']):.2f}x as fast")
            say(line)
    for sq, h in ((150, 8), (128, 128)):
        for dt in (torch.bfloat16, torch.float32):
            before = k2.mla_launches.count
            c = flash_case(1, sq, h, sq, h, 192, dt, g, ev=128,
                           scale=MLA_SCALE)
            err = check_case(c, f"flash_attention naive MLA sq={sq} h={h} "
                                f"{dt}")
            assert k2.mla_launches.count == before, "naive form in MLA mode"
            errs["flash_attention"] = max(errs["flash_attention"], err)
            line = (f"[kernels] flash_attention naive MLA form (192/128, "
                    f"generic route {k2.kernel_for(dt)}) sq={sq} h={h} "
                    f"{str(dt)[6:]}: max|err| {err:.2e} <= "
                    f"{tol_str(c['tol'])}")
            if dt == torch.bfloat16:
                line += " | " + fmt(measure(c))
            say(line)


def check_backward(g, errs):
    """K2's backward against its plain version from K2's own output and
    LSE (both held to the plain forward's), bf16 (the wgmma kernels,
    timed) and f32 (the CUDA-core kernels), at the training shape, g
    2/4/8 at e 128, whisper's encoder and a cross shape (non-causal),
    kv_len < sk with a ragged sq at an offset, e 16 (the reduced models'
    width) and g 3 (63-row query tiles); DeepSeek's naive MLA form (keys
    192, values 128, n = h, scale 1/sqrt(192), causal) at the moe train
    phase's shape (b 2, 512 positions, 128 heads: two warpgroups a dK/dV
    block) and at 150 positions of 8 heads.  No gradient may be all 0,
    and two runs must give the same bits."""
    from repro_torch.kernels import flash_attention_bwd as kb
    assert kb.kernel_for(torch.bfloat16) == ("flash_bwd_dkdv_wgmma",
                                             "flash_bwd_dq_wgmma")
    assert kb.kernel_for(torch.float32) == ("flash_bwd_dkdv", "flash_bwd_dq")
    cases = [("training shape b=8 s=256 h=n=16 e=64 causal",
              (8, 256, 16, 256, 16, 64), {})]
    cases += [(f"g={gq} e=128 b=2 s=256 causal", (2, 256, 4 * gq, 256, 4,
                                                  128), {})
              for gq in (2, 4, 8)]
    cases += [("whisper encoder 1500x1500 20 heads of 64 non-causal",
               (1, 1500, 20, 1500, 20, 64), dict(causal=False)),
              ("cross sq=16 sk=1601 g=8 e=128 non-causal",
               (1, 16, 64, 1601, 8, 128), dict(causal=False)),
              ("sq=77 at q_offset=24, kv_len=101 < sk=128, g=2 e=64",
               (2, 77, 8, 128, 4, 64), dict(q_offset=24, kv_len=101)),
              ("e=16 b=2 s=40 g=2 causal", (2, 40, 4, 40, 2, 16), {}),
              ("g=3 sq=50 sk=70 e=64 non-causal", (2, 50, 12, 70, 4, 64),
               dict(causal=False)),
              ("naive MLA 192/128 train moe b=2 s=512 h=n=128 causal",
               (2, 512, 128, 512, 128, 192), dict(ev=128, scale=MLA_SCALE)),
              ("naive MLA 192/128 sq=150 h=n=8 causal",
               (1, 150, 8, 150, 8, 192), dict(ev=128, scale=MLA_SCALE))]
    for what, shape, kw in cases:
        for dt in (torch.bfloat16, torch.float32):
            c = backward_case(*shape, dt, g, **kw)
            (o, lse), plain_fwd = c["fwd"]
            want_o, want_lse = plain_fwd()
            oerr = check_close(o, want_o, c["fwd_tols"][0],
                               f"K2 output {what} {dt}")
            lerr = check_close(lse, want_lse, c["fwd_tols"][1],
                               f"K2 LSE {what} {dt}")
            got, again = c["kernel"](), c["kernel"]()
            assert all(float(t.float().abs().max()) > 0 for t in got), \
                f"{what} {dt}: a gradient is all 0"
            assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(got, again)), \
                f"{what} {dt}: two runs differ"
            err = check_case(c, f"flash_attention_bwd {what} {dt}")
            line = (f"[kernels] flash_attention_bwd {what} {str(dt)[6:]} "
                    f"({'/'.join(kb.kernel_for(dt))}, two runs bit-equal): "
                    f"dq/dk/dv max|err| {err:.2e} <= "
                    f"{c['tol'][0]:.0e}·max|want| + {c['tol'][1]:.0e}·|want|;"
                    f" K2 output max|err| {oerr:.2e}, LSE {lerr:.2e}")
            if dt == torch.bfloat16:
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"], err)
                line += " | " + fmt(measure(c))
            say(line)


def role_times(fn, reps=10):
    """{kernel: device ms a call} of ``fn``'s launches under torch.profiler
    (K5's backward: each role's kernel, and ssd_bwd_finish)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = collections.defaultdict(float)
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.time_range.end > e.time_range.start):
            # "void (anonymous namespace)::name<args>(params)" -> name<args>
            m = re.search(r"(\w+(?:<[^>(]*>)?)\(", e.name)
            name = m.group(1) if m else e.name
            out[name] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    return dict(out)


def check_ssd_backward(g, errs):
    """K5's backward with each route forced at every shape it takes: bf16
    on the tensor cores (``ssd_bwd_mma``: ssd_bwd_keys_mma +
    ssd_bwd_queries_mma) and on the CUDA cores (``ssd_bwd_tiles``), f32
    on ``ssd_bwd_tiles``; at zamba2's widths (64 heads, P = N = 64, B and
    C one group broadcast to every head): Q in {1, 77, 256} with nc in
    {1, 2}, and the train shape (b 4, nc 2, Q 256); and a group per head
    at narrower widths.  Held as ``ssd_backward_case`` says; the plain
    version's own distance from the f64 evaluation is printed beside the
    kernel's.  Every gradient finite, dx, dB and dC not all 0, two runs
    bit-equal.  bf16 on the plan's route (the tensor cores) is timed at
    the zamba2 shapes; at the train shape both routes are timed, with
    each role kernel's device time."""
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    both = (torch.bfloat16, torch.float32)
    cases = [(f"zamba2 Q={Q} nc={nc}", (1, nc, Q, 64, 64, 64, True), both)
             for Q in (1, 77, 256) for nc in (1, 2)]
    cases += [("train shape b=4 nc=2 Q=256", (4, 2, 256, 64, 64, 64, True),
               both),
              ("a group per head b=2 nc=3 Q=32 H=4 P=16 N=8",
               (2, 3, 32, 4, 16, 8, False), both)]
    for what, shape, dtypes in cases:
        for dt in dtypes:
            routes = [k5b.plan(*shape[:6], dt).kernel]
            if routes[0] == "ssd_bwd_mma":
                routes.append("ssd_bwd_tiles")
            for route in routes:
                c = ssd_backward_case(*shape[:6], dt, shape[6], g, route)
                got, again = c["kernel"](), c["kernel"]()
                assert all(bool(t.isfinite().all()) for t in got), \
                    f"{what} {dt} {route}: a gradient is not finite"
                assert all(float(got[i].float().abs().max()) > 0
                           for i in (0, 2, 3)), \
                    f"{what} {dt} {route}: dx/dB/dC all 0"
                assert all(torch.equal(a.view(torch.uint8),
                                       b_.view(torch.uint8))
                           for a, b_ in zip(got, again)), \
                    f"{what} {dt} {route}: two runs differ"
                err = check_case(c, f"ssd_chunk_bwd {what} {dt} {route}")
                exact, plain = c["f64"](), c["plain"]()
                far = {n: (max_err(got[i], exact[i]),
                           max_err(plain[i], exact[i]))
                       for i, n in enumerate(SSD_BWD_NAMES)
                       if n in ("ddt", "ddA")}
                (a, r), (a32, r32) = BWD_TOL[dt], BWD_TOL[torch.float32]
                line = (f"[kernels] ssd_chunk_bwd {what} {str(dt)[6:]} "
                        f"{route} (two runs bit-equal): max|err| {err:.2e} "
                        f"(dx/dB/dC from the plain version within "
                        f"{a:.0e}·max|want| + {r:.0e}·|want|, ddt/ddA from "
                        f"f64 within {a32:.0e}·max|want| + "
                        f"{r32:.0e}·|want|); from f64, kernel / plain: "
                        + ", ".join(f"{n} {k:.2e} / {p:.2e}" for n, (k, p)
                                    in far.items()))
                timed_here = dt == torch.bfloat16 and (
                    route == routes[0] or what.startswith("train"))
                if dt == torch.bfloat16 and route == routes[0]:
                    errs["ssd_chunk_bwd"] = max(errs["ssd_chunk_bwd"], err)
                if timed_here and shape[6]:
                    line += " | " + fmt(measure(c))
                if what.startswith("train") and dt == torch.bfloat16:
                    line += " | by kernel (torch.profiler, us a call): " + \
                        ", ".join(f"{k} {1e3 * v:.1f}" for k, v in
                                  role_times(c["kernel"]).items())
                say(line)


def check_reduced_training():
    """One train step on the card against the CPU plain path from the same
    weights, on 2 x 64 tokens of ``launch.train.synthetic_data``: reduced
    f32 qwen1.5, whisper, xlstm, zamba2 (7 layers: a group, so the shared
    block runs, and a tail layer; chunks of 32) and llama-3.2-vision (a
    self and a cross block, xgate 0.5, a seeded source: K2 non-causal
    over the patches), and the small f32 deepseek-v2 and v3 at their
    published MLA widths (``published_mla_config``: 8 heads, v3's MTP
    block included; K2 at keys 192, values 128 with the scale, on the
    generic route): the loss within TRAIN_LOSS_TOL and every gradient
    within TRAIN_TOL (so none is 0 on the card that is not on the CPU),
    K2's backward launched where the model attends (once an attention
    block for deepseek), K5's once a Mamba2 layer; then the losses of 3
    AdamW steps on each device within TRAIN_LOSS_TOL (not the
    parameters: AdamW divides by sqrt(v), so an element whose gradient is
    near 0 may move by up to 2·lr on a sign that rounding decides).  An
    absorbed-form MLA call (576-wide queries over a latent head) under
    grad must still raise the no-backward error of K2's MLA mode."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import XGATE, published_mla_config
    from repro_torch.launch.train import synthetic_data
    from repro_torch.models import lm
    from repro_torch.training import (AdamWConfig, TrainConfig, adamw_init,
                                      make_train_step)
    from repro_torch.training.train_loop import value_and_grad
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    cfgs = [reduced(get_config(arch), layers=layers)
            for arch, layers in (("qwen1.5-0.5b", 2), ("whisper-large-v3", 2),
                                 ("xlstm-350m", 2), ("zamba2-1.2b", 7),
                                 ("llama-3.2-vision-90b", 2))]
    cfgs += [published_mla_config(arch)
             for arch in ("deepseek-v2-236b", "deepseek-v3-671b")]
    for cfg in cfgs:
        arch = cfg.name
        init, step = make_train_step(cfg, tcfg, "cpu")   # runs on any device
        cpu, cpu_state = init(18)
        for blk in cpu.modules():       # tanh(0) would drop cross-attention
            if getattr(blk, "xgate", None) is not None:
                blk.xgate.data.fill_(XGATE)
        gpu = copy.deepcopy(cpu).to("cuda")
        gpu_state = adamw_init(gpu, tcfg.optimizer)
        batch = next(synthetic_data(cfg, 2, 64, seed=18, device="cpu"))
        gbatch = {k: t.cuda() for k, t in batch.items()}

        def loss(p, b, cfg=cfg):
            return lm.loss_fn(p, cfg, b)
        ops.reset_launch_counts()
        (lc, _), gc_ = value_and_grad(loss, cpu, batch)
        (lg, _), gg = value_and_grad(loss, gpu, gbatch)
        bwd = ops.backward_launch_counts()
        lerr = abs(float(lg) - float(lc)) / abs(float(lc))
        assert lerr <= TRAIN_LOSS_TOL, f"{arch}: loss {lg} vs {lc}"
        gerr = max(check_close(gg[k].cpu(), gc_[k], TRAIN_TOL,
                               f"{arch} gradient {k}") for k in gc_)
        assert all(float(gg[k].abs().max()) > 0 for k in gc_
                   if float(gc_[k].abs().max()) > 0), f"{arch}: a 0 gradient"
        assert (bwd["flash_attention_bwd"] > 0) == (cfg.family != "ssm"), \
            (arch, bwd)
        if cfg.family == "moe":
            assert bwd["flash_attention_bwd"] == (cfg.num_layers
                                                  + cfg.mtp_depth), bwd
            assert ops.mla_launch_counts()["flash_attention"] == 0
        assert bwd["ssd_chunk_bwd"] == (cfg.num_layers if cfg.family
                                        == "hybrid" else 0), (arch, bwd)
        losses = {}
        for dev, (p, st, b) in (("cpu", (cpu, cpu_state, batch)),
                                ("cuda", (gpu, gpu_state, gbatch))):
            losses[dev] = []
            for _ in range(3):
                p, st, m = step(p, st, b)
                losses[dev].append(float(m["loss"]))
        np.testing.assert_allclose(losses["cuda"], losses["cpu"],
                                   rtol=TRAIN_LOSS_TOL)
        widths = (f", MLA widths q·k {cfg.mla.qk_head_dim} v "
                  f"{cfg.mla.v_head_dim}, {cfg.num_heads} heads, MTP "
                  f"{cfg.mtp_depth}" if cfg.family == "moe" else "")
        say(f"[models] train step {cfg.name} f32 reduced ({cfg.family}"
            f"{widths}), card vs CPU plain path: loss rel err {lerr:.2e}, "
            f"gradients ({len(gc_)} leaves) max|err| {gerr:.2e} <= "
            f"{tol_str(TRAIN_TOL)}, backward launches {bwd}; 3 AdamW "
            f"steps' losses card {losses['cuda']} cpu {losses['cpu']}")
    lat = torch.randn(1, 32, 1, 576, device="cuda", requires_grad=True)
    name = "flash_attention (K2) in MLA mode"
    try:
        ops.flash_attention(torch.randn(1, 8, 4, 576, device="cuda",
                                        requires_grad=True),
                            lat, lat[..., :512], q_offset=24,
                            scale=MLA_SCALE)
    except RuntimeError as e:
        assert f"{name} has no backward kernel" in str(e), str(e)
        say(f"[models] an absorbed-form MLA call (576/512 over a latent "
            f"head) under grad on the card raises: {str(e)[:90]}...")
    else:
        raise AssertionError("K2's absorbed MLA mode took a gradient")


def phase_models():
    import copy

    from repro_torch.launch.serve import build_pipeline
    from repro_torch.rag.agents import LMAgent
    from repro_torch.rag.embedder import Embedder
    from repro_torch.rag.vectordb import VectorDB
    # small input: the kernel path against the CPU plain path, same weights
    tok, emb, _, _, chat, _ = build_pipeline(1, device="cpu")
    gchat = LMAgent(chat.cfg, copy.deepcopy(chat.params).to("cuda"),
                    max_len=chat.max_len)
    gemb = Embedder(emb.cfg, copy.deepcopy(emb.params).to("cuda"))
    prompt = tok.encode("what drove the change in operating margin")[:16]
    cpu_ids = chat.generate(prompt, max_new=12, stop_at_eos=False).token_ids
    gpu_ids = gchat.generate(prompt, max_new=12, stop_at_eos=False).token_ids
    assert gpu_ids == cpu_ids, (gpu_ids, cpu_ids)
    batch = {"tokens": torch.tensor([prompt])}
    lc = chat.model.prefill(chat.params, batch, chat.model.init_cache(1, 32))
    lg = gchat.model.prefill(gchat.params, {"tokens": batch["tokens"].cuda()},
                             gchat.model.init_cache(1, 32))
    lerr = max_err(lg[0].cpu(), lc[0])
    assert lerr <= 1e-4, f"prefill logits off by {lerr}"
    docs = [tok.encode(f"document {i} about revenue and risk") for i in
            range(20)]
    e_cpu, e_gpu = emb.embed(docs), gemb.embed(docs)
    eerr = max_err(e_gpu.cpu(), e_cpu)
    assert eerr <= 1e-5, f"embeddings off by {eerr}"
    dbs = [VectorDB(emb.cfg.d_model, capacity=256, device=dv)
           for dv in ("cpu", "cuda")]
    for db, e in zip(dbs, (e_cpu, e_gpu)):
        db.add(e)
    (vc, ic), (vg, ig) = (db.search(e[:3], k=4) for db, e in
                          zip(dbs, (e_cpu, e_gpu)))
    assert (ic == ig).all() and np.abs(vc - vg).max() <= 1e-4
    say(f"[models] reduced f32, kernels vs CPU plain path: greedy ids equal "
        f"({len(gpu_ids)} tokens), prefill logits max|err| {lerr:.2e} <= 1e-4,"
        f" embeddings {eerr:.2e} <= 1e-5, search ids equal")
    check_reduced_zamba2()
    check_reduced_ring_and_cross()
    check_reduced_mla_and_xlstm()
    check_reduced_training()
    # published widths: every stage model gives finite, well-shaped output
    tok, emb, rr, rw, chat, draft = build_pipeline(0, device="cuda",
                                                   reduced=False)
    e = emb.embed(docs[:4])
    assert e.shape == (4, 1024) and bool(e.isfinite().all())
    assert float((e.norm(dim=-1) - 1).abs().max()) < 1e-3
    s = rr.score(prompt, docs[:3])
    assert s.shape == (3,) and np.isfinite(s).all()
    for agent in (rw, chat, draft):
        lg, _ = agent.model.prefill(agent.params, {"tokens": torch.tensor(
            [prompt], device="cuda")}, agent.model.init_cache(1, 64))
        assert lg.shape == (1, len(prompt), agent.cfg.vocab_size)
        assert bool(lg.isfinite().all()), agent.cfg.name
        ids = agent.generate(prompt, max_new=8, stop_at_eos=False).token_ids
        assert len(ids) == 8 and all(0 <= t < agent.cfg.vocab_size
                                     for t in ids)
    say(f"[models] published widths bf16: embed (4, 1024) unit-norm, rerank "
        f"scores finite, search/chat/draft logits finite, 8 greedy tokens "
        f"each; {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak")


def check_reduced_zamba2():
    """A reduced f32 zamba2 (7 layers: a group of 6 Mamba2 layers, the
    shared block, one tail layer) with the same weights on the CPU plain
    path and on the kernel path: ``ServingEngine`` gives equal greedy ids,
    and a prefill equal logits to 1e-4."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    cfg = reduced(get_config("zamba2-1.2b"), layers=7)
    cpu_params = build_model(cfg, "cpu").init(7)
    gpu_params = copy.deepcopy(cpu_params).to("cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in (20, 45, 77)]
    ids = []
    for params in (cpu_params, gpu_params):
        eng = ServingEngine(cfg, params, max_len=128, prefill_chunk=32,
                            token_group=4)
        for p in prompts:
            eng.submit(p, max_new=10)
        ids.append({r.rid: r.generated for r in eng.run_to_completion()})
    assert ids[0] == ids[1] and len(ids[0]) == 3, ids
    logits = []
    for params in (cpu_params, gpu_params):
        model = build_model(cfg, params.embed.device)
        tokens = torch.tensor([prompts[2]], device=params.embed.device)
        lg, _ = model.prefill(params, {"tokens": tokens},
                              model.init_cache(1, 96))
        logits.append(lg.cpu())
    err = max_err(logits[1], logits[0])
    assert err <= 1e-4, f"reduced zamba2 prefill logits off by {err}"
    say(f"[models] reduced f32 zamba2 (7 layers), kernels vs CPU plain path:"
        f" ServingEngine greedy ids equal (3 requests, "
        f"{sum(len(v) for v in ids[0].values())} tokens), 77-token prefill "
        f"logits max|err| {err:.2e} <= 1e-4")


def check_reduced_ring_and_cross():
    """The three families this slice ports, reduced (f32), with the same
    weights on the CPU plain path and on the kernel path: zamba2 (7
    layers) at max_len 40000, whose 4096-slot ring a 4200-token prompt
    wraps (prefill chunks of at most 2048), then 8 greedy tokens; whisper
    and llama-3.2-vision with xgate at 0.5 and a seeded source (16
    prompt tokens, 24 greedy tokens).  Greedy ids equal, prefill logits
    within 1e-4; zeroing the source changes the cross families' logits
    (the cross path is live)."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.profile_serve import (XGATE, cross_batch,
                                                  cross_generate,
                                                  cross_model)
    from repro_torch.models import build_model
    cfg = reduced(get_config("zamba2-1.2b"), layers=7)
    cpu = build_model(cfg, "cpu").init(9)
    toks = np.random.default_rng(9).integers(3, cfg.vocab_size, (1, 4200))
    out = []
    for params in (cpu, copy.deepcopy(cpu).to("cuda")):
        dev = params.embed.device
        model = build_model(cfg, dev)
        cache = model.init_cache(1, 40000)
        assert tuple(cache["attn"]["pos"].shape) == (1, 4096)
        for c0 in range(0, 4200, 2048):
            lg, cache = model.prefill(params, {"tokens": torch.from_numpy(
                toks[:, c0:c0 + 2048]).to(dev)}, cache)
        ids = [int(torch.argmax(lg[0, -1]))]
        for _ in range(7):
            lg1, cache = model.decode_step(
                params, torch.tensor([[ids[-1]]], device=dev), cache)
            ids.append(int(torch.argmax(lg1[0])))
        out.append((lg.cpu(), ids, cache["attn"]["pos"].cpu()))
    err = max_err(out[1][0], out[0][0])
    assert err <= 1e-4 and out[1][1] == out[0][1], (err, out[0][1],
                                                    out[1][1])
    assert torch.equal(out[1][2], out[0][2]), "ring positions differ"
    say(f"[models] reduced f32 zamba2 at max_len 40000 (a 4096-slot ring "
        f"wrapped by a 4200-token prompt), kernels vs CPU plain path: 8 "
        f"greedy ids equal, ring positions equal, last prefill chunk's "
        f"logits max|err| {err:.2e} <= 1e-4")
    for path in ("whisper", "vlm"):
        cfg, _, cpu = cross_model(path, torch.device("cpu"))
        batch = cross_batch(cfg, torch.device("cpu"))
        gpu = copy.deepcopy(cpu).to("cuda")
        gbatch = {k: v.cuda() for k, v in batch.items()}
        model = build_model(cfg, "cuda")
        (lc, ic), (lg, ig) = (
            cross_generate(build_model(cfg, "cpu"), cpu, batch),
            cross_generate(model, gpu, gbatch))
        err = max_err(lg.cpu(), lc)
        assert err <= 1e-4 and ig == ic, (path, err, ic, ig)
        src = next(k for k in gbatch if k != "tokens")
        zero, _ = cross_generate(model, gpu, {
            **gbatch, src: torch.zeros_like(gbatch[src])}, new_tokens=1)
        live = max_err(zero, lg)
        assert live > 1e-2, f"{path}: the cross path is dead ({live})"
        say(f"[models] reduced f32 {cfg.name} (xgate {XGATE}), kernels vs "
            f"CPU plain path: {len(ig)} greedy ids equal, prefill logits "
            f"max|err| {err:.2e} <= 1e-4; a zero source moves the logits "
            f"by {live:.2e}")


def check_reduced_mla_and_xlstm():
    """A small f32 deepseek-v2 with its published MLA widths (8 heads, a
    dense and a MoE block; ``published_mla_config``) and xlstm-350m
    reduced to 4 layers (its sLSTM at layer 3), the same weights on the
    CPU plain path and on the kernel path: a 150-token (45 for xlstm)
    prefill, then 8 greedy tokens.  Greedy ids equal, prefill logits
    within 1e-4; on the card deepseek's no-cache forward (the naive form,
    K2 at 192/128) against its cached prefill (the absorbed form, K2 MLA
    at 576/512) within 1e-3, and both MLA modes launched.  The
    no-cache forward's attention is the naive form (keys 192, values
    128, n = h): K2's generic route (flash_fwd in f32), not its MLA
    mode."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import published_mla_config
    from repro_torch.models import build_model
    for cfg, prompt in ((published_mla_config(), 150),
                        (reduced(get_config("xlstm-350m"), layers=4), 45)):
        cpu = build_model(cfg, "cpu").init(17)
        toks = torch.from_numpy(np.random.default_rng(17).integers(
            3, cfg.vocab_size, (1, prompt)))
        out = {}
        ops.reset_launch_counts()
        for params in (cpu, copy.deepcopy(cpu).to("cuda")):
            dev = params.embed.device
            model = build_model(cfg, dev)
            cache = model.init_cache(1, prompt + 8)
            lg, cache = model.prefill(params, {"tokens": toks.to(dev)},
                                      cache)
            ids = [int(torch.argmax(lg[0, -1]))]
            for _ in range(7):
                lg1, cache = model.decode_step(
                    params, torch.tensor([[ids[-1]]], device=dev), cache)
                ids.append(int(torch.argmax(lg1[0])))
            full = model.apply(params, {"tokens": toks.to(dev)})[0]
            out[dev.type] = (lg.cpu(), ids, full.cpu())
        mla = ops.mla_launch_counts()
        err = max_err(out["cuda"][0], out["cpu"][0])
        naive = max_err(out["cuda"][2], out["cuda"][0])
        assert err <= 1e-4 and out["cuda"][1] == out["cpu"][1], (
            cfg.name, err, out["cpu"][1], out["cuda"][1])
        assert naive <= 1e-3, f"{cfg.name}: forward vs prefill {naive}"
        if cfg.family == "moe":
            assert mla["decode_attention"] > 0 and \
                mla["flash_attention"] > 0, mla
        say(f"[models] {cfg.name} f32 ({cfg.num_layers} layers, "
            f"{cfg.num_heads} heads; MLA kv_lora {cfg.mla.kv_lora_rank}), "
            f"kernels vs CPU plain path: 8 greedy ids equal, prefill logits "
            f"max|err| {err:.2e} <= 1e-4; card forward vs prefill "
            f"{naive:.2e} <= 1e-3; MLA-mode launches {mla}")




class ShapeLog:
    """Counts the shapes each kernel wrapper is called with while the main
    path runs (it wraps the module functions; the launch counters stay the
    wrappers' own).  ``seen`` is read after the run: its first read waits
    for the device and reads each RingFill."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.lock = threading.Lock()
        self.raw = collections.defaultdict(collections.Counter)
        self._seen = None
        self.mods = {k.name: (k.module, REPLAY[k.name][0])
                     for k in (*ops.KERNELS, *ops.BACKWARD_KERNELS,
                               *ops.OPTIMIZER_KERNELS)}
        self.orig = {}

    def __enter__(self):
        for name, (mod, key) in self.mods.items():
            fn = self.orig[name] = getattr(mod, name)

            def rec(*a, _fn=fn, _key=key, _name=name, **kw):
                with self.lock:
                    self.raw[_name][_key(*a, **kw)] += 1
                return _fn(*a, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, (mod, _) in self.mods.items():
            setattr(mod, name, self.orig[name])

    @property
    def seen(self):
        if self._seen is None:
            torch.cuda.synchronize()
            self._seen = {}
            for name, raw in self.raw.items():
                self._seen[name] = collections.Counter()
                for key, count in raw.items():
                    self._seen[name][tuple(
                        x.read() if isinstance(x, RingFill) else x
                        for x in key)] += count
        return self._seen


def phase_serve(label, argv, then=None):
    """One ``serve.main`` run with the launch counters at 0 just before it
    and read just after; ``then(report)``, if given, checks more after."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()                     # just before the main path
    with ShapeLog() as shapes:
        rep = serve.main(["--full-width", *argv])
    counts = ops.launch_counts()                  # just after
    run = rep.session.last_run
    summary = dict(wall_s=rep.wall_s, tokens=rep.tokens,
                   tokens_per_s=rep.tokens / rep.wall_s, nodes=rep.nodes,
                   retries=rep.retries, stage_errors=rep.stage_errors,
                   stragglers=rep.stragglers,
                   decode_rounds=sum(r.decode_rounds for r in rep.results),
                   spec_rounds=run.spec_rounds, launches=counts,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   makespans=[r.makespan for r in rep.results])
    say(f"[serve:{label}] {json.dumps(summary)}")
    assert rep.unfinished == [], f"unfinished nodes: {rep.unfinished[:5]}"
    assert rep.retries == 0, f"{rep.retries} stage fns were retried"
    # every attempt, a cancelled straggler's too, whose error the runtime
    # drops unread
    assert rep.stage_errors == 0, f"{rep.stage_errors} stage fns raised"
    assert all(counts[k] > 0 for k in RAG_PATH), f"kernel not run: {counts}"
    assert rep.tokens > 0
    if then is not None:
        then(rep)
    del rep, run
    gc.collect()
    torch.cuda.empty_cache()
    return summary, shapes.seen


def check_spec_round(rep):
    """One speculative decode round, built by hand, through the served
    session's own ``chat_decode`` stage fn: two member streams, a group of
    8 tokens, the target's width-2 pass and the draft's candidates on the
    card.  Whether the scheduler makes a live round speculative depends on
    which PUs are idle at dispatch time, so a run may form none; this one
    runs by construction."""
    from repro_torch.core.dag import Node
    fn = rep.session.backend.stage_fns["chat_decode"]
    members = [Node(id=f"spec-check.{i}", stage="chat_decode",
                    kind="stream_decode", workload=8) for i in range(2)]
    node = Node(id="spec-check", stage="chat_decode", kind="stream_decode",
                workload=8, payload={"members": members, "decode_round": True,
                                     "decode_width": 2, "spec_width": 4})
    out = fn(node, 8)
    acc = node.payload["spec_accepts"]
    ids = sorted(m.id for m in members)
    assert sorted(out) == ids and sorted(acc) == ids, (out, acc)
    assert all(len(out[i]) == 8 and 0 <= acc[i] <= 8 for i in ids)
    say(f"[serve:serve+spec] a speculative round by hand: 2 streams x 8 "
        f"tokens, draft tokens accepted {[acc[i] for i in ids]}")


def phase_zamba2():
    """zamba2-1.2b at its published widths in bf16 (38 Mamba2 layers, d
    2048, 64 SSD heads with P = N = 64, chunk 256; the shared attention +
    MLP block after every 6 layers, 32 heads of 64, d_ff 8192; vocab
    32000), random weights from a seed.  A 300-token prefill (padded to two
    256-token chunks) gives finite logits; then ``ServingEngine`` serves
    the six requests of ``profile_serve.engine_workload`` (max_len 1024,
    prefill chunks of 128, decode groups of 8) with every launch counter
    at 0 just before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (ENGINE_NEW_TOKENS,
                                                  ENGINE_PROMPTS,
                                                  engine_model,
                                                  engine_workload)
    from repro_torch.serving.engine import MAX_SLOTS
    gc.collect()                      # the RAG models are gone by now
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = engine_model(torch.device("cuda"))
    V = cfg.vocab_size
    tokens = torch.tensor([np.random.default_rng(13).integers(
        3, V, 300).tolist()], device="cuda")
    lg, _ = model.prefill(params, {"tokens": tokens},
                          model.init_cache(1, 320))
    assert lg.shape == (1, 300, V) and bool(lg.isfinite().all())
    say(f"[models] {cfg.name} {cfg.dtype} ({cfg.num_layers} Mamba2 layers, "
        f"d {cfg.d_model}, shared block after every {cfg.ssm.attn_every}): "
        f"300-token prefill logits (1, 300, {V}) finite")
    del lg, tokens
    eng = engine_workload(cfg, params)
    torch.cuda.synchronize()
    done, steps, most_active = [], 0, 0
    ops.reset_launch_counts()                     # just before the main path
    t0 = time.perf_counter()
    with ShapeLog() as shapes:
        while eng.queue or eng.active:
            done += eng.step()
            steps += 1
            most_active = max(most_active, len(eng.active))
            assert steps < 1000, "the engine stopped making progress"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()                  # just after
    tokens = sum(len(r.generated) for r in done)
    summary = dict(wall_s=wall, requests=len(done), tokens=tokens,
                   tokens_per_s=tokens / wall,
                   prompt_tokens=sum(ENGINE_PROMPTS), steps=steps,
                   most_active=most_active, launches=counts,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    say(f"[serve:zamba2 engine] {json.dumps(summary)}")
    assert sorted(len(r.prompt_ids) for r in done) == list(ENGINE_PROMPTS), \
        "a request did not finish"
    assert all(r.done and r.prefilled == len(r.prompt_ids)
               and 1 <= len(r.generated) <= ENGINE_NEW_TOKENS
               and all(0 <= t < V for t in r.generated) for r in done)
    assert most_active <= MAX_SLOTS
    assert all(counts[k] > 0 for k in ENGINE_PATH), f"kernel not run: {counts}"
    del eng, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return summary, shapes.seen


def _free():
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _mode_launches(seen):
    """Launches of K1/K2 by mode, from the shapes a path gave them: the
    window mode (a ring) and the cross forms (K2 non-causal, K1 over a
    cross source)."""
    k1, k2 = seen.get("decode_attention", {}), seen.get("flash_attention", {})
    k1 = {k: c for k, c in k1.items() if not is_mla_key(k)}
    k2 = {k: c for k, c in k2.items() if not is_mla_key(k)}
    return {"decode_window": sum(c for k, c in k1.items() if len(k) > 6),
            "flash_window": sum(c for k, c in k2.items() if len(k) > 10),
            "flash_non_causal": sum(c for k, c in k2.items() if not k[7])}


def phase_zamba2_long():
    """zamba2-1.2b at its published widths in bf16 through
    ``ServingEngine(max_len=524288)``, the ``long_500k`` length, so the
    attention cache is a 4096-slot ring: one request, a 4608-token prompt
    in chunks of 128 (the ring wraps during prefill), then 32 new tokens,
    every decode step on K1's window mode over 4096 slots.  Counters at 0
    just before, read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (LONG_MAX_LEN,
                                                  LONG_NEW_TOKENS,
                                                  LONG_PROMPT, engine_model,
                                                  long_workload)
    _free()
    cfg, model, params = engine_model(torch.device("cuda"))
    ring = model.init_cache(1, LONG_MAX_LEN)["attn"]
    assert tuple(ring["pos"].shape) == (cfg.num_layers // cfg.ssm.attn_every,
                                        4096), ring["pos"].shape
    del ring
    eng = long_workload(cfg, params)
    torch.cuda.synchronize()
    ops.reset_launch_counts()                     # just before the main path
    t0 = time.perf_counter()
    with ShapeLog() as shapes:
        done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()                  # just after
    modes = _mode_launches(shapes.seen)
    (req,) = done
    summary = dict(wall_s=wall, max_len=LONG_MAX_LEN, ring_slots=4096,
                   prompt_tokens=LONG_PROMPT, tokens=len(req.generated),
                   tokens_per_s=len(req.generated) / wall, launches=counts,
                   launches_by_mode=modes,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    say(f"[serve:zamba2 long] {json.dumps(summary)}")
    assert req.done and req.prefilled == LONG_PROMPT
    assert 1 <= len(req.generated) <= LONG_NEW_TOKENS
    assert all(0 <= t < cfg.vocab_size for t in req.generated)
    assert all(counts[k] > 0 for k in ENGINE_PATH), f"kernel not run: {counts}"
    assert modes["decode_window"] > 0 and modes["flash_window"] > 0, modes
    del eng, params, model
    _free()
    return summary, shapes.seen


def phase_cross(path):
    """whisper-large-v3 whole (32 encoder and 32 decoder layers, d 1280, 20
    heads of 64), or llama-3.2-vision-90b at every width and 10 of its 100
    layers (two groups of one cross block and four self blocks; d 8192, 64
    heads over 8 kv heads of 128, vocab 128256), bf16, random weights from
    a seed with xgate at 0.5, through ``build_model(cfg, "cuda")``: a
    prefill of 16 tokens with a seeded source (1500 audio frames of 1280,
    or 1601 patch embeddings of 8192), then 24 greedy decode steps.
    Counters at 0 just before, read just after."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (cross_batch,
                                                  cross_generate,
                                                  cross_model)
    _free()
    cfg, model, params = cross_model(path, torch.device("cuda"))
    batch = cross_batch(cfg, torch.device("cuda"))
    n_params = sum(t.numel() for t in params.parameters())
    torch.cuda.synchronize()
    ops.reset_launch_counts()                     # just before the main path
    t0 = time.perf_counter()
    with ShapeLog() as shapes:
        logits, ids = cross_generate(model, params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()                  # just after
    modes = _mode_launches(shapes.seen)
    summary = dict(model=cfg.name, layers=cfg.num_layers,
                   params_b=n_params / 1e9, wall_s=wall,
                   prompt_tokens=batch["tokens"].shape[1], tokens=len(ids),
                   tokens_per_s=len(ids) / wall, launches=counts,
                   launches_by_mode=modes,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    say(f"[serve:{path}] {json.dumps(summary)}")
    assert bool(logits.isfinite().all()), "non-finite logits"
    assert logits.shape == (1, batch["tokens"].shape[1], cfg.vocab_size)
    assert all(0 <= t < cfg.vocab_size for t in ids)
    assert counts["decode_attention"] > 0 and counts["flash_attention"] > 0
    # the cross forms ran: K2 without a causal mask (the cross prefill, and
    # whisper's encoder) and K1 over the whole source
    T = (cfg.encdec.source_positions if cfg.family == "audio"
         else cfg.vlm.vision_tokens)
    cross_k1 = sum(c for k, c in shapes.seen["decode_attention"].items()
                   if k[3] == T)
    assert modes["flash_non_causal"] > 0 and cross_k1 > 0, (modes, cross_k1)
    say(f"[serve:{path}] K1 over the {T}-row source: {cross_k1} launches; "
        f"K2 non-causal: {modes['flash_non_causal']}")
    del params, model, batch, logits
    _free()
    return summary, shapes.seen


def phase_engine(path):
    """``ServingEngine`` with the model of ``path`` (``profile_serve``'s
    ``engine_model``): deepseek-engine is deepseek-v2-236b at every
    published width (d 5120, 128 heads, MLA q_lora 1536 / kv_lora 512 /
    nope 128 / rope 64 / v 128, 160 routed experts of 1536 top-6 and 2
    shared, the dense block's d_ff 12288, vocab 102400) and 4 of its 60
    layers; xlstm-engine is xlstm-350m whole (24 layers, d 1024, mLSTM 8
    heads of 256, sLSTM at 3 / 11 / 19).  bf16, random weights from seed
    12; the zamba2 engine's six requests (``engine_workload``), counters
    at 0 just before, read just after.  deepseek must run K1 and K2 in
    their MLA mode."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (ENGINE_NEW_TOKENS,
                                                  ENGINE_PROMPTS,
                                                  engine_model,
                                                  engine_workload)
    _free()
    cfg, _, params = engine_model(torch.device("cuda"), path)
    n_params = sum(t.numel() for t in params.parameters())
    eng = engine_workload(cfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()    # the serving peak, not init's
    done, steps = [], 0
    ops.reset_launch_counts()                     # just before the main path
    t0 = time.perf_counter()
    with ShapeLog() as shapes:
        while eng.queue or eng.active:
            done += eng.step()
            steps += 1
            assert steps < 1000, "the engine stopped making progress"
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, mla = ops.launch_counts(), ops.mla_launch_counts()  # just after
    tokens = sum(len(r.generated) for r in done)
    summary = dict(model=cfg.name, layers=cfg.num_layers,
                   params_b=n_params / 1e9, wall_s=wall, requests=len(done),
                   tokens=tokens, tokens_per_s=tokens / wall,
                   prompt_tokens=sum(ENGINE_PROMPTS), steps=steps,
                   launches=counts, mla_launches=mla,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    say(f"[serve:{path}] {json.dumps(summary)}")
    assert sorted(len(r.prompt_ids) for r in done) == list(ENGINE_PROMPTS), \
        "a request did not finish"
    assert all(r.done and r.prefilled == len(r.prompt_ids)
               and 1 <= len(r.generated) <= ENGINE_NEW_TOKENS
               and all(0 <= t < cfg.vocab_size for t in r.generated)
               for r in done)
    if cfg.family == "moe":
        assert mla["decode_attention"] > 0 and mla["flash_attention"] > 0, \
            f"MLA mode not run: {mla}"
    del eng, params
    _free()
    return summary, shapes.seen


def phase_train():
    """qwen1.5-0.5b at its published width in bf16 with remat "dots",
    random weights from seed 18, through ``repro_torch.training.train``
    on one fixed batch of ``launch.train.synthetic_data`` (8 x 256): 12
    AdamW steps at lr 1e-3, warm-up 1, every step logged (so each ends in
    a sync), counters at 0 just before and read just after.  Then 8 steps
    with an async checkpoint every 4 (keep 1) and ``train(steps=12,
    restore=True)``, which must start at step 8 and match the 12-step
    run's losses within RESTART_TOL."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (TRAIN_ARCH, TRAIN_BATCH,
                                                  TRAIN_SEQ)
    from repro_torch.launch.train import synthetic_data
    from repro_torch.training import AdamWConfig, TrainConfig, train
    _free()
    cfg = get_config(TRAIN_ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.dtype, cfg.remat) == (
        24, 1024, "bfloat16", "dots"), cfg
    dev = torch.device("cuda")
    batch = next(synthetic_data(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=18,
                                device=dev))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    torch.cuda.synchronize()
    ops.reset_launch_counts()                     # just before the main path
    with ShapeLog() as shapes:
        params, state, hist = train(cfg, itertools.repeat(batch),
                                    steps=TRAIN_STEPS, tcfg=tcfg, seed=18,
                                    log_every=1, device=dev)
    counts = ops.launch_counts()                  # just after
    bwd = ops.backward_launch_counts()
    opt = ops.optimizer_launch_counts()
    n_params = sum(p.numel() for p in params.parameters())
    n_leaves = len(list(params.parameters()))
    del params, state
    losses = [h["loss"] for h in hist]
    # each logged step ends in a sync (the loss read): a step's time is
    # the gap between two logs; the first step builds nothing but warms up
    step_s = statistics.median(b["wall"] - a["wall"]
                               for a, b in zip(hist[1:], hist[2:]))
    summary = dict(model=cfg.name, params_b=n_params / 1e9,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                   losses=losses, step_ms_median=1e3 * step_s,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=counts, bwd_launches=bwd,
                   opt_launches=opt,
                   k2_forward_per_step=counts["flash_attention"] / TRAIN_STEPS,
                   k2_backward_per_step=(bwd["flash_attention_bwd"]
                                         / TRAIN_STEPS))
    say(f"[train] {json.dumps(summary)}")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] <= losses[0] - TRAIN_DROP, losses
    assert bwd["flash_attention_bwd"] == cfg.num_layers * TRAIN_STEPS, bwd
    # every leaf through the AdamW kernel pair, one call a step
    assert opt == {"adamw": TRAIN_STEPS} and kadamw.leaves == n_leaves, (
        opt, kadamw.leaves, n_leaves)
    _free()
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=1)
        t0 = time.perf_counter()
        train(cfg, itertools.repeat(batch), steps=8, tcfg=tcfg, seed=18,
              checkpointer=ck, checkpoint_every=4, device=dev)
        saved = time.perf_counter() - t0
        assert ck.available_steps() == [8] and ck.latest_step() == 8
        t0 = time.perf_counter()
        rest = train(cfg, itertools.repeat(batch), steps=TRAIN_STEPS,
                     tcfg=tcfg, seed=18, checkpointer=ck, restore=True,
                     log_every=1, device=dev)[2]
        resumed = time.perf_counter() - t0
    assert [h["step"] for h in rest] == list(range(8, TRAIN_STEPS)), rest
    got = [h["loss"] for h in rest]
    np.testing.assert_allclose(got, losses[8:], rtol=RESTART_TOL)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses[8:]))
    say(f"[train] 8 steps with an async checkpoint every 4 in "
        f"{saved:.1f}s; restart from step {rest[0]['step']} to "
        f"{TRAIN_STEPS} in {resumed:.1f}s: losses {got} against the "
        f"uninterrupted run's {losses[8:]} (max rel diff {rel:.2e} <= "
        f"{RESTART_TOL:.0e})")
    _free()
    prof = profile_train_steps("train")
    summary.update(prof)
    say_profile("train", summary)
    _free()
    return summary, shapes.seen


def phase_train_hybrid():
    """zamba2-1.2b at its published width in bf16 with remat "dots" (38
    Mamba2 layers, d 2048, 64 SSD heads of P = N = 64, one group, chunks
    of 256, the shared block after every 6 layers), random weights from
    seed 18, through ``repro_torch.training.train`` on one fixed batch of
    ``launch.train.synthetic_data`` (4 x 512: two chunks a row, so the
    state between them carries a gradient): 12 AdamW steps at lr 1e-3,
    warm-up 1, every step logged, counters at 0 just before and read
    just after.  A step launches K5's backward once a Mamba2 layer and
    K2's once a pass of the shared block.  Then 3 profiled steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (HYBRID_ARCH, HYBRID_BATCH,
                                                  HYBRID_SEQ)
    from repro_torch.launch.train import synthetic_data
    from repro_torch.training import AdamWConfig, TrainConfig, train
    _free()
    cfg = get_config(HYBRID_ARCH)
    s = cfg.ssm
    assert (cfg.num_layers, cfg.d_model, s.expand * cfg.d_model // s.head_dim,
            s.head_dim, s.state_size, s.ngroups, s.chunk_size, s.attn_every,
            cfg.dtype, cfg.remat) == (38, 2048, 64, 64, 64, 1, 256, 6,
                                      "bfloat16", "dots"), cfg
    passes = cfg.num_layers // s.attn_every       # of the shared block
    dev = torch.device("cuda")
    batch = next(synthetic_data(cfg, HYBRID_BATCH, HYBRID_SEQ, seed=18,
                                device=dev))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    torch.cuda.synchronize()
    ops.reset_launch_counts()                     # just before the main path
    with ShapeLog() as shapes:
        params, state, hist = train(cfg, itertools.repeat(batch),
                                    steps=TRAIN_STEPS, tcfg=tcfg, seed=18,
                                    log_every=1, device=dev)
    counts = ops.launch_counts()                  # just after
    bwd = ops.backward_launch_counts()
    opt = ops.optimizer_launch_counts()
    n_params = sum(p.numel() for p in params.parameters())
    n_leaves = len(list(params.parameters()))
    del params, state
    losses = [h["loss"] for h in hist]
    step_s = statistics.median(b["wall"] - a["wall"]
                               for a, b in zip(hist[1:], hist[2:]))
    summary = dict(model=cfg.name, params_b=n_params / 1e9,
                   batch=HYBRID_BATCH, seq=HYBRID_SEQ, steps=TRAIN_STEPS,
                   losses=losses, step_ms_median=1e3 * step_s,
                   tokens_per_s=HYBRID_BATCH * HYBRID_SEQ / step_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=counts, bwd_launches=bwd,
                   opt_launches=opt,
                   k5_forward_per_step=counts["ssd_chunk"] / TRAIN_STEPS,
                   k5_backward_per_step=bwd["ssd_chunk_bwd"] / TRAIN_STEPS,
                   k2_backward_per_step=(bwd["flash_attention_bwd"]
                                         / TRAIN_STEPS))
    say(f"[train hybrid] {json.dumps(summary)}")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] <= losses[0] - TRAIN_DROP, losses
    assert bwd["ssd_chunk_bwd"] == cfg.num_layers * TRAIN_STEPS, bwd
    # every leaf through the AdamW kernel pair, one call a step
    assert opt == {"adamw": TRAIN_STEPS} and kadamw.leaves == n_leaves, (
        opt, kadamw.leaves, n_leaves)
    assert bwd["flash_attention_bwd"] == passes * TRAIN_STEPS, bwd
    _free()
    prof = profile_train_steps("train-hybrid")
    summary.update(prof)
    say_profile("train hybrid", summary)
    _free()
    return summary, shapes.seen


def phase_train_moe():
    """deepseek-v2-236b at every published width in bf16 with its remat
    "full" (d 5120, 128 heads, q_lora 1536, kv_lora 512, nope 128, rope
    64, v 128, expert d_ff 1536, 2 shared experts, top-6, vocab 102400),
    cut two ways (``profile_serve.moe_train_config``): depth to
    first_k_dense + 1 = 2 layers (one dense, one MoE), and the routed
    experts from 160 to 64 (with 160 the weights, gradients and AdamW
    moments alone take 64 GB, before AdamW's f32 temporaries of the
    expert leaf); random weights from seed 18, through
    ``repro_torch.training.train`` on one fixed 2 x 512 batch of
    ``launch.train.synthetic_data``: 12 AdamW steps at lr 1e-3, warm-up
    1, every step logged, counters at 0 just before and read just after.
    A step launches K2's backward once an MLA layer (2), and every K2
    forward of the run is the naive form (keys 192, values 128) on the
    generic route (bf16: flash_fwd_wgmma), none in MLA mode.  Then 3
    profiled steps."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (MOE_BATCH, MOE_EXPERTS,
                                                  MOE_LAYERS, MOE_SEQ,
                                                  moe_train_config)
    from repro_torch.launch.train import synthetic_data
    from repro_torch.training import AdamWConfig, TrainConfig, train
    _free()
    cfg = moe_train_config()
    m, e = cfg.mla, cfg.moe
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, m.q_lora_rank,
            m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim,
            m.v_head_dim, e.d_ff, e.num_shared_experts, e.top_k,
            e.num_experts, e.first_k_dense, cfg.vocab_size, cfg.dtype,
            cfg.remat) == (MOE_LAYERS, 5120, 128, 1536, 512, 128, 64, 128,
                           1536, 2, 6, MOE_EXPERTS, 1, 102400, "bfloat16",
                           "full"), cfg
    dev = torch.device("cuda")
    batch = next(synthetic_data(cfg, MOE_BATCH, MOE_SEQ, seed=18,
                                device=dev))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    torch.cuda.synchronize()
    ops.reset_launch_counts()                     # just before the main path
    with ShapeLog() as shapes:
        params, state, hist = train(cfg, itertools.repeat(batch),
                                    steps=TRAIN_STEPS, tcfg=tcfg, seed=18,
                                    log_every=1, device=dev)
    counts = ops.launch_counts()                  # just after
    bwd = ops.backward_launch_counts()
    mla = ops.mla_launch_counts()
    opt = ops.optimizer_launch_counts()
    n_params = sum(p.numel() for p in params.parameters())
    n_leaves = len(list(params.parameters()))
    del params, state
    losses = [h["loss"] for h in hist]
    step_s = statistics.median(b["wall"] - a["wall"]
                               for a, b in zip(hist[1:], hist[2:]))
    summary = dict(model=f"{cfg.name} ({MOE_LAYERS} of 60 layers, "
                         f"{MOE_EXPERTS} of 160 routed experts)",
                   params_b=n_params / 1e9, batch=MOE_BATCH, seq=MOE_SEQ,
                   steps=TRAIN_STEPS, losses=losses,
                   step_ms_median=1e3 * step_s,
                   tokens_per_s=MOE_BATCH * MOE_SEQ / step_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=counts, bwd_launches=bwd, mla_launches=mla,
                   opt_launches=opt,
                   k2_forward_per_step=counts["flash_attention"] / TRAIN_STEPS,
                   k2_backward_per_step=(bwd["flash_attention_bwd"]
                                         / TRAIN_STEPS))
    say(f"[train moe] {json.dumps(summary)}")
    k2_keys = shapes.seen["flash_attention"]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] <= losses[0] - TRAIN_DROP, losses
    assert bwd["flash_attention_bwd"] == MOE_LAYERS * TRAIN_STEPS, bwd
    # every leaf through the AdamW kernel pair, one call a step
    assert opt == {"adamw": TRAIN_STEPS} and kadamw.leaves == n_leaves, (
        opt, kadamw.leaves, n_leaves)
    assert mla["flash_attention"] == 0 and counts["flash_attention"] > 0
    assert k2_keys and all(
        k[0] == "naive" and k[7:9] == (192, torch.bfloat16) and k[12] == 128
        for k in k2_keys), k2_keys
    _free()
    prof = profile_train_steps("train-moe")
    summary.update(prof)
    say_profile("train moe", summary)
    _free()
    return summary, shapes.seen


def say_profile(label, summary):
    b = summary["backward"]
    say(f"[{label}] profiled {summary['profiled_steps']} steps: device "
        f"time {summary['device_ms_per_step']:.1f} ms a step (the union of "
        f"its kernels) against a step wall of "
        f"{summary['step_ms_median']:.1f} ms (the 12-step run's median; "
        f"{summary['profiled_wall_ms_per_step']:.1f} ms profiled, busy "
        f"{100 * summary['busy_share']:.1f}%); " + "; ".join(
            f"{name} {1e3 * v['ms_per_launch']:.1f} us a launch "
            f"({v['launches']} launches, its kernels summed), "
            f"{v['ms_per_step']:.2f} ms a step" for name, v in b.items()))


def profile_train_steps(path):
    """A train path's device time: ``profile_serve.train_runner(path)``'s
    steps (the same model, batch and optimizer) once to warm up, then
    once under torch.profiler: the union of the kernel intervals a step,
    its share of the profiled wall, and each backward kernel's device
    time per launch of its wrapper (those that ran)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import _union_ms, train_runner
    run = train_runner(torch.device("cuda"), path)
    run()
    before = ops.backward_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
    after = ops.backward_launch_counts()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.time_range.end > e.time_range.start]
    steps = out["steps"]
    backward = {}
    for k in ops.BACKWARD_KERNELS:
        launched = after[k.name] - before[k.name]
        if not launched:
            continue
        ms = sum(b - a for a, b, name in spans
                 if any(s in name for s in k.symbols)) / 1e3
        assert ms > 0, (k.name, launched)
        backward[k.name] = dict(launches=launched, ms_per_launch=ms / launched,
                                ms_per_step=ms / steps)
    assert backward, "no backward kernel ran"
    device = _union_ms([(a, b) for a, b, _ in spans])
    return dict(profiled_steps=steps, device_ms_per_step=device / steps,
                profiled_wall_ms_per_step=1e3 * out["wall_s"] / steps,
                busy_share=device / (1e3 * out["wall_s"]),
                backward=backward)


def phase_document_qa():
    """``examples/document_qa_torch.py --full-width``: W2 for two
    finqabench traces through a live ``HeroSession`` over
    ``launch.serve.build_stage_fns`` at the published qwen3 widths in
    bf16, counters at 0 just before it and read just after; both queries
    must finish every node (one ``on_stage_done`` completion each) and
    K1-K3 must launch."""
    import importlib.util
    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        "document_qa_torch", ROOT / "examples" / "document_qa_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    _free()
    ops.reset_launch_counts()                     # just before the main path
    t0 = time.perf_counter()
    results, done = example.main(["--full-width"])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()                  # just after
    summary = dict(wall_s=wall, queries=len(results),
                   nodes=[r.n_nodes for r in results],
                   completions=len(done),
                   makespans=[r.makespan for r in results],
                   launches=counts,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    say(f"[document_qa] {json.dumps(summary)}")
    assert len(results) == 2, results
    assert len(done) == sum(r.n_nodes for r in results) > 0, summary
    assert all(counts[k] > 0 for k in RAG_PATH), f"kernel not run: {counts}"
    del results, done
    _free()
    return summary


def phase_kernels_bench(seen_by_path):
    """``launch/kernels_bench.run`` at each path's most frequent shape of
    each kernel row, as this run's paths gave them (K4 at its off-path
    shape): a CSV row per (path, kernel), every kernel and backward kernel
    of ``ops`` among them."""
    from repro_torch.kernels import ops
    from repro_torch.launch import kernels_bench
    keys = {path: {name: shapes.most_common(1)[0][0]
                   for name, shapes in _split_mla(seen).items() if shapes}
            for path, seen in seen_by_path.items()}
    keys["none"] = kernels_bench.PATH_KEYS["none"]
    say(f"[bench] most frequent shape keys: {keys!r}")
    rows = kernels_bench.run(csv=lambda line: say(f"[bench] {line}"),
                             keys=keys)
    names = {r["name"] for r in rows}
    want = {k.name for k in (*ops.KERNELS, *ops.BACKWARD_KERNELS,
                             *ops.OPTIMIZER_KERNELS)}
    assert want <= names, want - names
    return rows


def phase_dryrun():
    """The dry-run's counter on the card: qwen1.5-0.5b's train step at
    the train phase's shape (8 x 256, remat "dots", the same AdamW) counted
    by ``launch/op_cost.py`` on the card, then the same step on the meta
    device (the dry-run's mesh "1"): FLOPs, bytes and kernel calls must be
    equal, and the card's kernel calls equal its launches.  The counted
    FLOPs over the step's measured time (the median of 5, each ending in a
    sync) give the step's share of the card's bf16 peak."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.h100 import PEAK_FLOPS
    from repro_torch.launch.profile_serve import (TRAIN_ARCH, TRAIN_BATCH,
                                                  TRAIN_SEQ)
    from repro_torch.training import AdamWConfig, TrainConfig
    _free()
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    ops.reset_launch_counts()
    card, step = dryrun.count_train_step(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                         "cuda", tcfg, seed=18)
    torch.cuda.synchronize()
    launched = {**ops.launch_counts(), **ops.backward_launch_counts(),
                **ops.optimizer_launch_counts()}
    meta, _ = dryrun.count_train_step(cfg, TRAIN_BATCH, TRAIN_SEQ, "meta",
                                      tcfg, seed=18)
    for _ in range(2):
        step()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    share = card.flops / step_s / PEAK_FLOPS[torch.bfloat16]
    counts = {d: dict(flops=c.flops, bytes=c.bytes, kernels=dict(c.kernels),
                      kernel_flops=c.kernel_flops,
                      peak_live_gib=c.peak_bytes / 2**30)
              for d, c in (("card", card), ("meta", meta))}
    say(f"[dryrun] {cfg.name} train step {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"counted on the card and on meta: {json.dumps(counts)}")
    say(f"[dryrun] {cfg.name} train step: {card.flops / 1e12:.3f} TFLOP "
        f"counted in {1e3 * step_s:.1f} ms a step (median of 5: "
        f"{[round(1e3 * t, 1) for t in times]}) = "
        f"{card.flops / step_s / 1e12:.2f} TFLOP/s, {100 * share:.2f}% of "
        f"989 TFLOP/s bf16 on {_smi()}")
    assert (card.flops, card.bytes, dict(card.kernels)) == (
        meta.flops, meta.bytes, dict(meta.kernels)), counts
    assert all(launched[k] == n for k, n in card.kernels.items()), (
        launched, dict(card.kernels))
    del step
    _free()
    return dict(counts, step_ms=1e3 * step_s, peak_share=share)


def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _split_mla(seen):
    """A path's shapes with K1's and K2's MLA-mode keys under their own
    rows (MLA_ROW)."""
    out = {}
    for name, keys in seen.items():
        for key, count in keys.items():
            row = MLA_ROW[name] if is_mla_key(key) else name
            out.setdefault(row, collections.Counter())[key] += count
    return out


def _replay(name, shapes, memo, g):
    """Per-launch means over ``shapes`` ({key: launches}), each key checked
    and timed once (``memo``) on fresh random inputs."""
    total = sum(shapes.values())
    acc = collections.defaultdict(float)
    bytes_time = ops_time = 0.0
    err, library = 0.0, True
    for key, count in shapes.items():
        if (name, key) not in memo:
            c = REPLAY[name][1](key, g)
            if "scores" in c:                   # top-k: values and ids
                e = check_topk(c, exact_ids=False)[0]
            else:
                e = check_case(c, f"{name} {key}")
            memo[name, key] = (measure(c), e)
        t, e = memo[name, key]
        err = max(err, e)
        for f in ("ms", "host_ms", "plain_ms", "bound_ms"):
            acc[f] += count * t[f]
        if t["library_ms"] is None:
            library = False
        else:
            acc["library_ms"] += count * t["library_ms"]
        if t["bound_by"] == "bytes":
            bytes_time += count * t["bound_ms"]
        else:
            ops_time += count * t["bound_ms"]
    out = {f: v / total for f, v in acc.items()}
    out["library_ms"] = out.get("library_ms") if library else None
    return dict(out, bound_by="bytes" if bytes_time >= ops_time
                else "operations", max_abs_err=err, shapes=len(shapes),
                calls=total)


def phase_timing(seen_by_path):
    """Replays every shape each main path gave each kernel; per-launch
    means weighted by how often the path used each shape, per path and
    over the paths together."""
    g = torch.Generator(device="cuda").manual_seed(1)
    memo, out = {}, {}
    seen_by_path = {p: _split_mla(seen) for p, seen in seen_by_path.items()}
    names = sorted({n for seen in seen_by_path.values() for n in seen})
    for name in names:
        both = collections.Counter()
        by_path = {}
        for path, seen in seen_by_path.items():
            if seen.get(name):
                both.update(seen[name])
                by_path[path] = _replay(name, seen[name], memo, g)
                say(f"[timing] {name} on {path}: {by_path[path]['calls']} "
                    f"launches over {by_path[path]['shapes']} shapes, per "
                    f"launch: " + fmt(by_path[path])
                    + f", max|err| {by_path[path]['max_abs_err']:.2e}")
        out[name] = dict(_replay(name, both, memo, g), by_path=by_path)
        say(f"[timing] {name}, all paths: per launch: " + fmt(out[name]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    say(f"[env] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()
    errs, k4_time = phase_kernels()
    phase_models()
    # each stage runs once, so launches and shapes are the query's own
    iso, seen = phase_serve("isolated W2", ["--workflow", "2",
                                            "--queries", "1",
                                            "--no-straggler-redispatch"])
    assert iso["stragglers"] == 0
    # the scheduler as it ships: straggler re-dispatch on.  Whether it
    # forms batched or speculative rounds depends on which PUs are idle at
    # dispatch time, so their counts are reported, and a speculative round
    # built by hand runs through the session's stage fns after it
    cont, _ = phase_serve("serve+spec", ["--serve", "--spec-decode",
                                         "--queries", "2",
                                         "--inter-arrival", "0.05"],
                          then=check_spec_round)
    eng, seen_eng = phase_zamba2()
    long, seen_long = phase_zamba2_long()
    whisper, seen_whisper = phase_cross("whisper")
    vlm, seen_vlm = phase_cross("vlm")
    deepseek, seen_deepseek = phase_engine("deepseek-engine")
    xlstm, _ = phase_engine("xlstm-engine")
    train_run, seen_train = phase_train()
    hybrid_run, seen_hybrid = phase_train_hybrid()
    moe_run, seen_moe = phase_train_moe()
    doc_qa = phase_document_qa()
    phase_dryrun()
    seen_by_path = {"w2_isolated": seen, "zamba2_engine": seen_eng,
                    "zamba2_long": seen_long, "whisper": seen_whisper,
                    "vlm": seen_vlm, "deepseek_engine": seen_deepseek,
                    "train": seen_train, "train_hybrid": seen_hybrid,
                    "train_moe": seen_moe}
    timing = phase_timing(seen_by_path)
    phase_kernels_bench(seen_by_path)
    runs = {"w2_isolated": iso, "serve_spec": cont, "zamba2_engine": eng,
            "zamba2_long": long, "whisper": whisper, "vlm": vlm,
            "deepseek_engine": deepseek, "xlstm_engine": xlstm,
            "train": train_run, "train_hybrid": hybrid_run,
            "train_moe": moe_run, "document_qa": doc_qa}
    table = []
    from repro_torch.kernels import ops
    rows = [(k, k.name, lambda r, n=k.name: r["launches"][n]
             - r.get("mla_launches", {}).get(n, 0)) for k in ops.KERNELS]
    rows += [(k, MLA_ROW[k.name],
              lambda r, n=k.name: r.get("mla_launches", {}).get(n, 0))
             for k in ops.KERNELS if k.name in MLA_ROW]
    rows += [(k, k.name, lambda r, n=k.name: r.get("bwd_launches",
                                                   {}).get(n, 0))
             for k in ops.BACKWARD_KERNELS]
    rows += [(k, k.name, lambda r, n=k.name: r.get("opt_launches",
                                                   {}).get(n, 0))
             for k in ops.OPTIMIZER_KERNELS]
    for k, name, launched in rows:
        by_path = {p: launched(r) for p, r in runs.items()}
        if name in timing:
            t = timing[name]
            extra = dict(main_path_shapes=t["shapes"],
                         ms_by_path={p: v["ms"]
                                     for p, v in t["by_path"].items()})
        else:       # K4: on no path; timed at a zamba2 projection's shape
            assert sum(by_path.values()) == 0, by_path
            t = dict(k4_time, max_abs_err=0.0)
            extra = dict(timed_at="M=128 K=2048 N=4096 (on no path)",
                         timed_kernel="int8_mm_wgmma")
        if isinstance(k, ops.BackwardKernel):   # no TPU kernel: the JAX
            replaces = k.autodiff_of            # function XLA differentiates
            extra.update(differentiates=k.differentiates)
        else:
            replaces = k.replaces
        table.append(dict(
            name=name, route="cuda", source=k.source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(errs[name], t["max_abs_err"]),
            ms=t["ms"], host_ms=t["host_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"], **extra))
        assert math.isfinite(t["ms"]) and t["ms"] > 0
    say(f"[done] {time.monotonic() - t0:.1f}s")
    print(json.dumps({"kernels": table}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
