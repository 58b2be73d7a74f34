"""Where the device time of one served workload goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path zamba2-engine
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path zamba2-long
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path whisper
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path vlm
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path deepseek-engine
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path xlstm-engine
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path train
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path train-hybrid
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --path train-parts

(``--device cpu`` rehearses the script with the reduced models on the CPU,
where no kernel runs on a device.)

``--path w2`` (the default) builds the live pipeline at the published
widths (bf16, CUDA) and serves one isolated W2 query, with straggler
re-dispatch off so that every stage runs once.  ``--path zamba2-engine``
builds zamba2-1.2b at full width (bf16) and serves ``ENGINE_PROMPTS``
through ``ServingEngine`` (max_len 1024, prefill chunks of 128, decode
groups of 8, 24 new tokens each): ``engine_model`` and
``engine_workload``, which ``chip_smoke.py`` serves too.
``--path zamba2-long`` serves one request at the ``long_500k`` length
(``max_len`` 524288, so the attention cache is a 4096-slot ring): a
4608-token prompt in chunks of 128, then 32 new tokens
(``long_workload``).  ``--path whisper`` and ``--path vlm`` build
whisper-large-v3 (whole) or llama-3.2-vision-90b (every width, depth cut
to ``VLM_LAYERS``) with ``xgate`` at 0.5, and run a prefill of 16 tokens
with a seeded source (1500 audio frames, or 1601 patch embeddings), then
24 greedy decode steps (``cross_model``, ``cross_batch``,
``cross_generate``).  ``--path deepseek-engine`` and ``--path
xlstm-engine`` serve the zamba2 engine's requests through
``ServingEngine`` with deepseek-v2-236b (every width, depth cut to
``DEEPSEEK_LAYERS``: the first-k dense block and three MoE blocks) or
xlstm-350m (whole) in its place (``engine_model(dev, path)``).
``--path train`` trains qwen1.5-0.5b at its published width (bf16, remat
"dots", AdamW) on one fixed 8 x 256 batch of ``launch.train.
synthetic_data``: a run is ``TRAIN_PROFILE_STEPS`` steps
(``train_runner``), so its kernel table counts K2's backward too.
``--path train-hybrid`` does the same with zamba2-1.2b whole on one
fixed 4 x 512 batch (two chunks of 256 a row), whose table counts K5's
backward and K2's.
``--path train-parts`` is not profiled: for each remat policy ("dots",
"none", "full") it times the parts of a step of the same model on the
same batch, each alone between two syncs (``train_step_parts``), and
prints them as JSON.
Each runs once unprofiled (warm-up: allocator, cuBLAS handles, kernel
build) and once under ``torch.profiler``, and prints as JSON: the wall
time of the profiled run, the device's busy share of it (the union of
kernel intervals over the wall time), its peak device memory, the
kernel time by category (the port's CUDA kernels, GEMMs, everything
else) and the 12 heaviest kernels.  The profiler's own host overhead
lengthens the wall time, so the busy share is a lower bound.
"""
from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device, torch_dtype
from repro_torch.api import HeroSession, SessionOptions
from repro_torch.configs import SHAPES_BY_NAME
from repro_torch.core.events import EV_STRAGGLER
from repro_torch.kernels import ops
from repro_torch.launch.serve import (NO_STRAGGLER_REDISPATCH,
                                      RecordingLiveBackend, StageCounts,
                                      build_stage_fns)
from repro_torch.rag import default_means, sample_traces

# the zamba2 engine workload: prompt lengths (at most 4 of the 6 hold a
# slot at once; the 333-token prompt ends in a 77-token chunk)
ENGINE_PROMPTS = (64, 200, 333, 512, 700, 900)
ENGINE_NEW_TOKENS = 24
# zamba2 at long context: the prompt wraps the 4096-slot ring during
# prefill, so every decode step attends over all 4096 slots
LONG_MAX_LEN = SHAPES_BY_NAME["long_500k"].seq_len
LONG_PROMPT, LONG_NEW_TOKENS = 4608, 32
# the cross-attention families: a 16-token prompt over a seeded source
CROSS_ARCHS = {"whisper": "whisper-large-v3", "vlm": "llama-3.2-vision-90b"}
CROSS_PROMPT, CROSS_NEW_TOKENS = 16, 24
# llama-3.2-vision-90b is about 180 GB in bf16 at its 100 layers; two
# groups (one cross block and four self blocks each) keep every width in
# about 22 GB, the untied 128256 x 8192 embedding and head included
VLM_LAYERS = 10
XGATE = 0.5     # tanh(0) = 0 would multiply the cross-attention away

# the engine paths and their models: deepseek-v2-236b is about 472 GB in
# bf16 at its 60 layers; the first-k dense block and three MoE blocks
# keep every width in about 27 GB (13.3 B parameters)
ENGINE_ARCHS = {"zamba2-engine": "zamba2-1.2b",
                "deepseek-engine": "deepseek-v2-236b",
                "xlstm-engine": "xlstm-350m"}
DEEPSEEK_LAYERS = 4
# the train path: qwen1.5-0.5b whole (the default arch of
# repro/launch/train.py), one fixed 8 x 256 batch, lr 1e-3
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_PROFILE_STEPS = \
    "qwen1.5-0.5b", 8, 256, 3
# the hybrid family's train path: zamba2-1.2b whole on one fixed 4 x 512
# batch, two chunks of 256 a row, so the state between them carries a
# gradient
HYBRID_ARCH, HYBRID_BATCH, HYBRID_SEQ = "zamba2-1.2b", 4, 512
TRAIN_PATHS = {"train": (TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ),
               "train-hybrid": (HYBRID_ARCH, HYBRID_BATCH, HYBRID_SEQ)}

# the port's own kernels, by their __global__ names
PORT_KERNELS = tuple(s for k in (*ops.KERNELS, *ops.BACKWARD_KERNELS)
                     for s in k.symbols)
GEMM = ("gemm", "xmma", "cutlass", "cublas", "gemv", "nvjet")   # cuBLAS
TOP = 12


def category(name: str) -> str:
    low = name.lower()
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if any(k in low for k in GEMM):
        return "gemm"
    return "other"


def _union_ms(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3          # profiler times are in microseconds


def w2_runner(dev: torch.device) -> Callable[[], dict]:
    """-> a function that serves one isolated W2 query and returns its
    wall time, per-stage latencies, stragglers and tokens."""
    counts = StageCounts()
    stage_fns = build_stage_fns(device=dev, reduced=dev.type == "cpu",
                                counts=counts)

    def run() -> dict:
        counts.tokens = 0
        out = serve_once(stage_fns)
        assert counts.errors == 0, f"{counts.errors} stage fns raised"
        return dict(out, tokens=counts.tokens)
    return run


def engine_config(path: str, dev: torch.device):
    """The model of an engine path: zamba2-1.2b and xlstm-350m whole,
    deepseek-v2-236b at every width and ``DEEPSEEK_LAYERS`` layers.  On
    the CPU each is reduced at f32 (zamba2 to 7 layers, deepseek to a
    dense and two MoE blocks, xlstm to 4 with its first sLSTM)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    cfg = get_config(ENGINE_ARCHS[path])
    if dev.type == "cpu":
        layers = {"hybrid": 7, "moe": 3, "ssm": 4}[cfg.family]
        return reduced(cfg, layers=layers)
    if cfg.family == "moe":
        return dataclasses.replace(cfg, num_layers=DEEPSEEK_LAYERS)
    return cfg


def published_mla_config(arch: str = "deepseek-v2-236b", layers: int = 2,
                         heads: int = 8):
    """A small f32 DeepSeek whose MLA widths are the published ones
    (kv_lora 512, rope 64, nope 128, v 128, q_lora 1536), so that a check
    of the card against the CPU runs the MLA kernels at the path's
    widths: d_model 256, ``heads`` heads, the first-k dense block then
    MoE blocks of 4 experts (top-2, one shared), vocab 256."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    cfg = get_config(arch)
    return dataclasses.replace(
        reduced(cfg, layers=layers, d_model=256), mla=cfg.mla,
        num_heads=heads, num_kv_heads=heads, head_dim=cfg.mla.v_head_dim)


def engine_model(dev: torch.device, path: str = "zamba2-engine"):
    """-> (cfg, model, params) of an engine path (:func:`engine_config`),
    random weights from seed 12."""
    from repro_torch.models import build_model
    cfg = engine_config(path, dev)
    model = build_model(cfg, dev)
    return cfg, model, model.init(12)


def engine_workload(cfg, params):
    """-> a fresh ``ServingEngine`` over ``params`` (max_len 1024, prefill
    chunks of 128, decode groups of 8) with the workload's requests
    submitted: ``ENGINE_PROMPTS`` of random ids from seed 12,
    ``ENGINE_NEW_TOKENS`` new tokens each."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(cfg, params, max_len=1024, prefill_chunk=128,
                        token_group=8)
    rng = np.random.default_rng(12)
    for n in ENGINE_PROMPTS:
        eng.submit(rng.integers(3, cfg.vocab_size, n).tolist(),
                   max_new=ENGINE_NEW_TOKENS)
    return eng


def engine_runner(dev: torch.device,
                  path: str = "zamba2-engine") -> Callable[[], dict]:
    """-> a function that serves the engine workload with ``path``'s model
    (a fresh engine each time, the same prompts) and returns its wall
    time and tokens."""
    cfg, _, params = engine_model(dev, path)

    def run() -> dict:
        eng = engine_workload(cfg, params)
        t0 = time.monotonic()
        done = eng.run_to_completion()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        assert len(done) == len(ENGINE_PROMPTS), "a request did not finish"
        return {"wall_s": time.monotonic() - t0, "requests": len(done),
                "tokens": sum(len(r.generated) for r in done)}
    return run


def long_workload(cfg, params):
    """-> a fresh ``ServingEngine`` over ``params`` at ``LONG_MAX_LEN``
    (a ring cache; prefill chunks of 128, decode groups of 8) with one
    request: ``LONG_PROMPT`` random ids from seed 14, ``LONG_NEW_TOKENS``
    new tokens."""
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(cfg, params, max_len=LONG_MAX_LEN, prefill_chunk=128,
                        token_group=8)
    rng = np.random.default_rng(14)
    eng.submit(rng.integers(3, cfg.vocab_size, LONG_PROMPT).tolist(),
               max_new=LONG_NEW_TOKENS)
    return eng


def long_runner(dev: torch.device) -> Callable[[], dict]:
    """-> a function that serves the long-context request (a fresh engine
    each time) and returns its wall time and tokens."""
    cfg, _, params = engine_model(dev)

    def run() -> dict:
        eng = long_workload(cfg, params)
        t0 = time.monotonic()
        done = eng.run_to_completion()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        assert len(done) == 1, "the request did not finish"
        return {"wall_s": time.monotonic() - t0, "requests": 1,
                "tokens": len(done[0].generated)}
    return run


def cross_model(path: str, dev: torch.device):
    """-> (cfg, model, params) of ``--path whisper`` or ``--path vlm``:
    random weights from seed 15 with every ``xgate`` at ``XGATE``; vlm at
    ``VLM_LAYERS`` layers.  On the CPU the model is reduced (whisper to 2
    encoder and 2 decoder layers, vlm to 4 layers in two groups) at f32."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    cfg = get_config(CROSS_ARCHS[path])
    if dev.type == "cpu":
        cfg = reduced(cfg, layers=2 if cfg.family == "audio" else 4)
    elif cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, num_layers=VLM_LAYERS)
    model = build_model(cfg, dev)
    params = model.init(15)
    for blk in params.modules():
        if getattr(blk, "xgate", None) is not None:
            blk.xgate.data.fill_(XGATE)
    return cfg, model, params


def cross_batch(cfg, dev: torch.device, seed: int = 16) -> dict:
    """A ``CROSS_PROMPT``-token prompt and the seeded source: audio frames
    (1, source_positions, d) or patch embeddings (1, vision_tokens,
    vision_dim), standard normal, in the model's dtype."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        key, shape = "audio_frames", (cfg.encdec.source_positions,
                                      cfg.d_model)
    else:
        key, shape = "vision_embeds", (cfg.vlm.vision_tokens,
                                       cfg.vlm.vision_dim)
    src = torch.from_numpy(rng.standard_normal((1, *shape)).astype(
        np.float32)).to(dev, torch_dtype(cfg.dtype))
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                           (1, CROSS_PROMPT))).to(dev)
    return {"tokens": tokens, key: src}


@torch.no_grad()
def cross_generate(model, params, batch: dict,
                   new_tokens: int = CROSS_NEW_TOKENS):
    """Prefill (which stores the source's cross k/v) and greedy decode
    (which reads them) -> (prefill logits, generated ids)."""
    dev = batch["tokens"].device
    cache = model.init_cache(1, batch["tokens"].shape[1] + new_tokens)
    logits, cache = model.prefill(params, batch, cache)
    ids = [int(torch.argmax(logits[0, -1]))]
    for _ in range(new_tokens - 1):
        lg, cache = model.decode_step(
            params, torch.tensor([[ids[-1]]], device=dev), cache)
        ids.append(int(torch.argmax(lg[0])))
    return logits, ids


def cross_runner(path: str, dev: torch.device) -> Callable[[], dict]:
    """-> a function that runs the prefill and greedy decode of ``path``
    and returns its wall time and tokens."""
    cfg, model, params = cross_model(path, dev)
    batch = cross_batch(cfg, dev)

    def run() -> dict:
        t0 = time.monotonic()
        _, ids = cross_generate(model, params, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return {"wall_s": time.monotonic() - t0, "tokens": len(ids)}
    return run


def train_runner(dev: torch.device,
                 path: str = "train") -> Callable[[], dict]:
    """-> run(): TRAIN_PROFILE_STEPS AdamW steps of ``TRAIN_PATHS[path]``'s
    model (full width, or reduced on the CPU) on its one fixed batch; the
    model and its state persist across runs."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import synthetic_data
    from repro_torch.training import AdamWConfig, TrainConfig
    from repro_torch.training import make_train_step
    arch, b, seq = TRAIN_PATHS[path]
    cfg = get_config(arch)
    if dev.type != "cuda":
        cfg = reduced(cfg)
    init, step = make_train_step(cfg, TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=1)), dev)
    state = list(init(18))
    batch = next(synthetic_data(cfg, b, seq, seed=18, device=dev))

    def run():
        t0 = time.monotonic()
        for _ in range(TRAIN_PROFILE_STEPS):
            state[0], state[1], metrics = step(state[0], state[1], batch)
        loss = float(metrics["loss"])       # waits for the device
        return {"wall_s": time.monotonic() - t0, "loss": loss,
                "steps": TRAIN_PROFILE_STEPS,
                "tokens": TRAIN_PROFILE_STEPS * b * seq}
    return run


def train_step_parts(dev: torch.device, remat: str) -> dict:
    """The loss forward, forward + backward and AdamW update of one step
    of ``train_runner``'s model with ``remat``, each timed alone between
    two syncs (host clock, ms, median of 3 after 2 warm-up steps), and the
    whole step; the peak memory of those 3 rounds."""
    import dataclasses
    import statistics

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import synthetic_data
    from repro_torch.models import lm
    from repro_torch.training import (AdamWConfig, TrainConfig, adamw_update,
                                      make_train_step)
    from repro_torch.training.train_loop import value_and_grad
    cfg = get_config(TRAIN_ARCH)
    if dev.type != "cuda":
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, remat=remat)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    init, step = make_train_step(cfg, tcfg, dev)
    params, state = init(18)
    batch = next(synthetic_data(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=18,
                                device=dev))

    def loss(p, b):
        return lm.loss_fn(p, cfg, b)

    def synced(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, 1e3 * (time.perf_counter() - t0)
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    times: Dict[str, List[float]] = collections.defaultdict(list)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        times["forward_ms"].append(synced(lambda: loss(params, batch))[1])
        (_, grads), t = synced(lambda: value_and_grad(loss, params, batch))
        times["forward_backward_ms"].append(t)
        times["adamw_ms"].append(synced(lambda: adamw_update(
            grads, state, params, tcfg.optimizer))[1])
        del grads
        times["step_ms"].append(synced(lambda: step(params, state,
                                                    batch))[1])
    out = {k: statistics.median(v) for k, v in times.items()}
    out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else None)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve_once(stage_fns) -> dict:
    """One isolated W2 query; -> its wall time and per-stage latencies."""
    traces = sample_traces("finqabench", 1, seed=1)
    backend = RecordingLiveBackend(stage_fns)
    sess = HeroSession(world="sd8gen4", family="qwen3", backend=backend,
                       means=default_means(traces),
                       options=SessionOptions(
                           cfg_overrides=NO_STRAGGLER_REDISPATCH))
    sess.submit(traces[0], wf=2)
    t0 = time.monotonic()
    (result,) = sess.run(mode="isolated", timeout=600)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"wall_s": time.monotonic() - t0,
            "stage_latency_s": result.stage_latency,
            "stragglers": sum(1 for e in backend.events
                              if e[1] == EV_STRAGGLER)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--path", choices=("w2", *ENGINE_ARCHS, "zamba2-long",
                                       *CROSS_ARCHS, *TRAIN_PATHS,
                                       "train-parts"),
                    default="w2")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.path == "train-parts":
        out = {"device": (torch.cuda.get_device_name(0)
                          if dev.type == "cuda" else "cpu"),
               "path": args.path, "arch": TRAIN_ARCH,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ}
        for remat in ("dots", "none", "full"):
            out[remat] = train_step_parts(dev, remat)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        print(json.dumps(out, indent=1))
        return out
    if args.path in CROSS_ARCHS:
        run_once = cross_runner(args.path, dev)
    elif args.path in ENGINE_ARCHS:
        run_once = engine_runner(dev, args.path)
    elif args.path in TRAIN_PATHS:
        run_once = train_runner(dev, args.path)
    else:
        run_once = {"w2": w2_runner, "zamba2-long": long_runner}[args.path](
            dev)
    warm = run_once()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = run_once()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.end > e.time_range.start]
    by_cat: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0])
    by_port: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0])
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_cat[category(e.name)] += ms
        by_name[e.name][0] += ms
        by_name[e.name][1] += 1
        port = max((k for k in PORT_KERNELS if k in e.name), key=len,
                   default=None)
        if port is not None:
            by_port[port][0] += ms
            by_port[port][1] += 1
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    out = {
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
        "path": args.path,
        "warm_wall_s": warm["wall_s"], "profiled_wall_s": run["wall_s"],
        **{k: v for k, v in run.items() if k != "wall_s"},
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                     if dev.type == "cuda" else None),
        "kernel_launches": len(kernels),
        "device_busy_ms": busy,
        "device_busy_share": busy / (run["wall_s"] * 1e3),
        "kernel_ms_by_category": dict(by_cat),
        "top_kernels": [{"name": n[:90], "ms": v[0], "launches": v[1]}
                        for n, v in top],
        "port_kernels": {n: {"ms": v[0], "launches": v[1]}
                         for n, v in sorted(by_port.items())},
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
