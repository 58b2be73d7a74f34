#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never the JAX package) in phases; any
failure ends the run with a non-zero exit code and no result line:

1. build    — compile the CUDA kernels (one nvcc per source, in parallel).
2. kernels  — each kernel against its plain PyTorch version on the card at
              the main path's full-width shapes, in bf16 and f32 (TF32 off),
              with its time, the plain version's and a library yardstick's.
3. models   — the kernel path against the CPU plain path on a small input
              (same weights), and finite, well-shaped outputs of every stage
              model at the published widths.
4. serve    — one isolated W2 query with straggler re-dispatch off (every
              stage runs once, so its launch counts are the query's own),
              then a ``--serve --spec-decode`` run of two staggered queries
              with it on, through ``repro_torch.launch.serve`` at the
              published qwen3 / qwen1.5-0.5b widths in bf16.  Each run
              starts with every launch counter at 0 and must finish every
              DAG node with no stage fn retried, no exception in any attempt
              (a cancelled straggler's included) and every kernel launched.
5. timing   — each kernel, its plain version and the yardstick replayed at
              every shape the isolated W2 query gave it, weighted by launches.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.  Needs one GPU, no network.
"""
from __future__ import annotations

import collections
import gc
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor cores
              torch.float32: 67e12}           # f32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def say(*a):
    print(*a, flush=True)


_CYCLES_PER_MS = []


def _spin_rate():
    """Clock cycles per millisecond of ``torch.cuda._sleep``'s spin."""
    if not _CYCLES_PER_MS:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(20_000_000)
        e.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(20_000_000 / s.elapsed_time(e))
    return _CYCLES_PER_MS[0]


def _issue(fn, reps):
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    return ev


def _median_ms(ev):
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def timed(fn, reps=15, warmup=3):
    """-> (device_ms, host_ms), medians over ``reps`` calls (CUDA events).

    device_ms: the calls are queued behind a spin kernel that outlasts
    their issue, so the card runs them back to back and the events time
    the card's work alone.  The spin counts clock cycles, so its length in
    ms moves with the clock; it is timed too, and if the host took longer
    to issue the calls than the spin lasted, the run is repeated behind a
    longer spin.  host_ms: each call issued to an idle card, as a caller
    sees it, the wrapper's host work (Python, ctypes, allocation)
    included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = _median_ms(_issue(fn, reps))
    cycles = _spin_rate() * (3 * (time.perf_counter() - t0) * 1e3 + 1)
    for _ in range(4):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(int(cycles))
        e.record()
        t0 = time.perf_counter()
        ev = _issue(fn, reps)
        issue_ms = (time.perf_counter() - t0) * 1e3
        dev = _median_ms(ev)
        spin_ms = s.elapsed_time(e)
        if issue_ms < spin_ms:
            return dev, host
        cycles *= 3 * issue_ms / spin_ms
    raise RuntimeError(f"the host took {issue_ms:.1f} ms to issue {reps} "
                       f"calls, longer than every spin ({spin_ms:.1f} ms)")


def bound_ms(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(got, want, tol, what):
    """|got - want| <= tol + tol * |want| elementwise (numpy's allclose
    with atol = rtol = tol, as tests/test_kernels.py); -> max |err|."""
    got, want = got.float(), want.float()
    bad = (got - want).abs() > tol + tol * want.abs()
    err = max_err(got, want)
    assert not bool(bad.any()), f"{what}: max|err| {err:.3e} over {tol:.0e}"
    return err


# ---------------------------------------------------------------------------
# one kernel call: its inputs, kernel, plain version, yardstick, bound
# ---------------------------------------------------------------------------

def rand(shape, dtype, g):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def decode_case(b, h, n, S, e, dtype, g, lengths=None):
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ref
    q = rand((b, h, e), dtype, g)
    kc, vc = rand((b, S, n, e), dtype, g), rand((b, S, n, e), dtype, g)
    lens = torch.tensor(lengths or [S] * b, dtype=torch.int32, device="cuda")

    def library():      # SDPA over the (b, n, S, e) view: all rows length S
        return F.scaled_dot_product_attention(
            q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            enable_gqa=True)[:, :, 0]
    bnd = bound_ms(k1.bytes_moved(q, kc, lens), k1.flops(q, lens, S), dtype)
    return dict(kernel=lambda: k1.decode_attention(q, kc, vc, lens),
                plain=lambda: ref.decode_attention_ref(q, kc, vc, lens),
                library=library if lengths is None else None, bound=bnd,
                tol=TOL[dtype])


def flash_case(b, sq, h, sk, n, e, dtype, g, causal=True, q_offset=0,
               kv_len=None):
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ref
    q = rand((b, sq, h, e), dtype, g)
    k, v = rand((b, sk, n, e), dtype, g), rand((b, sk, n, e), dtype, g)
    kv_len = sk if kv_len is None else kv_len
    # SDPA's is_causal is top-left aligned, i.e. q_offset 0; otherwise a
    # boolean mask
    plain_causal = causal and q_offset == 0 and kv_len == sk
    mask = None
    if causal and not plain_causal:
        mask = (torch.arange(sq, device="cuda")[:, None] + q_offset
                >= torch.arange(sk, device="cuda")[None])
    if kv_len < sk:
        valid = torch.arange(sk, device="cuda")[None] < kv_len
        mask = valid if mask is None else mask & valid

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=plain_causal,
            enable_gqa=True).transpose(1, 2)
    bnd = bound_ms(k2.bytes_moved(q, k, kv_len),
                   k2.flops(q, kv_len, causal, q_offset), dtype)
    return dict(kernel=lambda: k2.flash_attention(
                    q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len),
                plain=lambda: ref.flash_attention_ref(
                    q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len),
                library=library, bound=bnd, tol=TOL[dtype])


def topk_case(nq, N, d, k, g, queries=None, corpus=None):
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_retrieval as k3
    q = (F.normalize(rand((nq, d), torch.float32, g), dim=-1)
         if queries is None else queries)
    c = (F.normalize(rand((N, d), torch.float32, g), dim=-1)
         if corpus is None else corpus)
    bnd = bound_ms(k3.bytes_moved(q, c, k), k3.flops(q, c), torch.float32)
    return dict(kernel=lambda: k3.topk_retrieval(q, c, k),
                plain=lambda: ref.topk_retrieval_ref(q, c, k),
                library=lambda: torch.topk(q @ c.T, k),
                bound=bnd, tol=1e-4, scores=lambda: q @ c.T)


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


def measure(case):
    """Device and host-paced times of the kernel, the plain version and
    the library yardstick, beside the bound."""
    t = {}
    for key, prefix in (("kernel", ""), ("plain", "plain_"),
                        ("library", "library_")):
        dev, host = timed(case[key]) if case[key] else (None, None)
        t[f"{prefix}ms"], t[f"{prefix}host_ms"] = dev, host
    t["bound_ms"], t["bound_by"] = case["bound"]
    return t


def fmt(t):
    lib = "-" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
    return (f"kernel {t['ms']:.4f} ms (host-paced {t['host_ms']:.4f}) | "
            f"plain {t['plain_ms']:.4f} ms | library {lib} ms | "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build, ops
    t0 = time.monotonic()
    took = _build.build(k.name for k in ops.KERNELS)
    say(f"[build] {len(took)} libraries in {time.monotonic() - t0:.1f}s "
        f"(nvcc {_build.nvcc()})")


def phase_kernels():
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = collections.defaultdict(float)
    say("[kernels] TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
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
                            f"{c['tol']:.0e}")
                    if dt == torch.bfloat16:
                        line += " | " + fmt(measure(c))
                    say(line)
    c = decode_case(3, 32, 8, 300, 128, torch.bfloat16, g,
                    lengths=[300, 77, 0])
    err = check_close(c["kernel"](), c["plain"](), c["tol"],
                      "decode ragged lengths")
    say(f"[kernels] decode_attention ragged lengths [300,77,0]: "
        f"max|err| {err:.2e}")
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
                        f"{err:.2e} <= {c['tol']:.0e}")
                if dt == torch.bfloat16:
                    line += " | " + fmt(measure(c))
                say(line)
    # K3: the path's tiny corpus, a full VectorDB capacity, exact ties
    for nq, N, d, k in ((1, 128, 1024, 112), (16, 65536, 1024, 8),
                        (16, 65536, 1024, 131)):
        c = topk_case(nq, N, d, k, g)
        err, flips = check_topk(c, exact_ids=False)
        errs["topk_retrieval"] = max(errs["topk_retrieval"], err)
        say(f"[kernels] topk_retrieval nq={nq} N={N} d={d} k={k}: max|err| "
            f"{err:.2e} <= 1e-04, {flips} ids swapped inside near-ties | "
            + fmt(measure(c)))
    # multiples of 1/8 with |x| <= 2/8: every score is exact in f32 in any
    # order of summation, so ties are true ties and ids must match exactly
    ints = torch.randint(-2, 3, (4104, 64), generator=g, device="cuda")
    c = topk_case(8, 4096, 64, 256, g, queries=ints[:8].float() / 8,
                  corpus=ints[8:].float() / 8)
    err, _ = check_topk(c, exact_ids=True)
    say(f"[kernels] topk_retrieval exact scores with ties, k=256: ids equal, "
        f"max|err| {err:.2e}")
    return errs


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


def _k1_key(q, kc, vc, lengths):
    b, h, e = q.shape
    return (b, h, kc.shape[2], kc.shape[1], e, q.dtype)


def _k2_key(q, k, v, *, causal=True, q_offset=0, kv_len=None):
    b, sq, h, e = q.shape
    return (b, sq, h, k.shape[1], k.shape[2], e, q.dtype, causal, q_offset,
            kv_len)


def _k3_key(queries, corpus, k):
    return (queries.shape[0], corpus.shape[0], queries.shape[1], k)


# per kernel of repro_torch.kernels.ops.KERNELS: the shape key of one
# wrapper call, and the case that replays a key on fresh random inputs
REPLAY = {
    "decode_attention": (_k1_key, lambda key, g: decode_case(*key, g)),
    "flash_attention": (_k2_key, lambda key, g: flash_case(*key[:7], g,
                                                           *key[7:])),
    "topk_retrieval": (_k3_key, lambda key, g: topk_case(*key, g)),
}


class ShapeLog:
    """Counts the shapes each kernel wrapper is called with while the main
    path runs (it wraps the module functions; the launch counters stay the
    wrappers' own)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.lock = threading.Lock()
        self.seen = collections.defaultdict(collections.Counter)
        self.mods = {k.name: (k.module, REPLAY[k.name][0])
                     for k in ops.KERNELS}
        self.orig = {}

    def __enter__(self):
        for name, (mod, key) in self.mods.items():
            fn = self.orig[name] = getattr(mod, name)

            def rec(*a, _fn=fn, _key=key, _name=name, **kw):
                with self.lock:
                    self.seen[_name][_key(*a, **kw)] += 1
                return _fn(*a, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for name, (mod, _) in self.mods.items():
            setattr(mod, name, self.orig[name])


def phase_serve(label, argv):
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
    assert all(v > 0 for v in counts.values()), f"kernel not run: {counts}"
    assert rep.tokens > 0
    del rep, run
    gc.collect()
    torch.cuda.empty_cache()
    return summary, shapes.seen


def phase_timing(seen):
    """Replays every shape the main path gave each kernel; per-launch means
    weighted by how often the path used each shape."""
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, shapes in seen.items():
        total = sum(shapes.values())
        acc = collections.defaultdict(float)
        bytes_time = ops_time = 0.0
        err = 0.0
        for key, count in shapes.items():
            c = REPLAY[name][1](key, g)
            if "scores" in c:                   # top-k: values and ids
                err = max(err, check_topk(c, exact_ids=False)[0])
            else:
                err = max(err, check_close(c["kernel"](), c["plain"](),
                                           c["tol"], f"{name} {key}"))
            t = measure(c)
            for f in ("ms", "host_ms", "plain_ms", "library_ms", "bound_ms"):
                acc[f] += count * t[f]     # every replayed case has a library
            if t["bound_by"] == "bytes":
                bytes_time += count * t["bound_ms"]
            else:
                ops_time += count * t["bound_ms"]
        out[name] = dict({f: v / total for f, v in acc.items()},
                         bound_by="bytes" if bytes_time >= ops_time
                         else "operations",
                         max_abs_err=err, shapes=len(shapes),
                         calls=total)
        say(f"[timing] {name}: {total} launches over {len(shapes)} shapes, "
            f"per launch: " + fmt(out[name]) + f", max|err| {err:.2e}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    say(f"[env] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()
    errs = phase_kernels()
    phase_models()
    # each stage runs once, so launches and shapes are the query's own
    iso, seen = phase_serve("isolated W2", ["--workflow", "2",
                                            "--queries", "1",
                                            "--no-straggler-redispatch"])
    assert iso["stragglers"] == 0
    # the scheduler as it ships: straggler re-dispatch on
    cont, _ = phase_serve("serve+spec", ["--serve", "--spec-decode",
                                         "--queries", "2",
                                         "--inter-arrival", "0.05"])
    assert cont["decode_rounds"] > 0 and cont["spec_rounds"] > 0, \
        "the continuous run formed no batched or speculative round"
    timing = phase_timing(seen)
    table = []
    from repro_torch.kernels import ops
    for k in ops.KERNELS:
        name, t = k.name, timing[k.name]
        table.append(dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=iso["launches"][name],
            launches_serve_spec=cont["launches"][name],
            max_abs_err=max(errs[name], t["max_abs_err"]),
            ms=t["ms"], host_ms=t["host_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            main_path_shapes=t["shapes"]))
        assert math.isfinite(t["ms"]) and t["ms"] > 0
    say(f"[done] {time.monotonic() - t0:.1f}s")
    print(json.dumps({"kernels": table}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
