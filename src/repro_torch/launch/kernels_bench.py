"""Kernel bench of the port: each hand-written kernel against its plain
PyTorch version and its library call, timed on the card with CUDA events
at the main paths' shapes -- the counterpart of
``benchmarks/kernels_bench.py``, which times the JAX package's reference
functions on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.kernels_bench

prints one CSV row per kernel of ``ops.KERNELS``,
``ops.BACKWARD_KERNELS`` and ``ops.OPTIMIZER_KERNELS`` (K1's and K2's MLA
mode a row of its own) on each path that launches it, at that path's most frequent shape
(:data:`PATH_KEYS`, keys as :data:`REPLAY` makes them):
``name, path, device_us, host_us, bound_us, bound_by, plain_us,
library_us``.  ``device_us`` is the card's time a launch with the calls
queued back to back, ``host_us`` a call issued to an idle card as a
caller sees it (:func:`timed`); the bound is the larger of the wrapper's
``bytes_moved`` over the memory rate and its ``flops`` over the peak of
their type (``launch/h100.py``); the library call is SDPA,
``torch.topk``, ``torch._int_mm`` or ``torch._fused_adamw_`` (none for
K5).  Needs one NVIDIA
GPU; ``chip_smoke.py`` holds each kernel against its plain version with
the cases and limits defined here, and replays the shapes its paths gave
each kernel.
"""
from __future__ import annotations

import collections
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.launch.h100 import HBM_BYTES_PER_S, PEAK_FLOPS

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# K1/K2 in bf16 where every query sees at least MANY_KEYS keys (the window
# and cross shapes; for the MLA mode against the near-exact version, see
# mla_decode_case): (atol, rtol).  Over that many keys the probabilities'
# rounding averages out, and what is left is the output's rounding, at most
# one bf16 step (2^-7 of the value), so a key let in or left out at a
# window's edge shows.  Rows of fewer keys keep TOL: there one rounded
# probability can move an output near 0 by 2^-9 of a value.
MANY_KEYS = 128
MANY_KEYS_TOL = (2e-3, 1e-2)
# K5's outputs are f32 in both input types: sums of up to 256 products in
# another order than the plain version's (the reference sweep's tolerance)
SSD_TOL = 2e-4


# K1's and K2's MLA mode, a row of its own in the kernel table
MLA_ROW = {"decode_attention": "decode_attention (MLA mode)",
           "flash_attention": "flash_attention (MLA mode)"}
MLA_SCALE = 192 ** -0.5       # deepseek: 1/sqrt(qk_nope + qk_rope)


# K2's backward against its plain version, both computing in f32 from the
# same inputs and the forward's LSE: (atol as a share of the gradient's
# largest |value|, rtol).  f32: sums of up to 1500·g products in another
# order; bf16: the gradients' one rounding to bf16 (a step is 2^-8 to
# 2^-7 of the value).  K2's LSE against the plain one: (atol, rtol).
BWD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 1e-2)}
LSE_TOL = (1e-4, 1e-5)


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


def paced(fn, reps=5, warmup=1):
    """-> (ms, ms): :func:`timed`'s host-paced time alone, for a call of
    thousands of launches (AdamW's plain loop, the library's), which fill
    the launch queue before any spin ends."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = _median_ms(_issue(fn, reps))
    return ms, ms


def bound_ms(nbytes, *work):
    """The larger of the bytes' time at the memory rate and the
    operations' time; ``work`` is (operations, dtype) pairs, each priced
    at its type's peak and summed."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[dtype] for n, dtype in work)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_tol(dtype, fewest_keys):
    """K1/K2's limit for a call whose rows each see ``fewest_keys`` keys
    or more."""
    if dtype == torch.bfloat16 and fewest_keys >= MANY_KEYS:
        return MANY_KEYS_TOL
    return TOL[dtype]



# ---------------------------------------------------------------------------
# one kernel call: its inputs, kernel, plain version, yardstick, bound
# ---------------------------------------------------------------------------

def rand(shape, dtype, g):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def decode_case(b, h, n, S, e, dtype, g, lengths=None, nsplit=None,
                slots=None, window=0, ring_end=None):
    """``nsplit`` forces the split count (else ``split_plan``'s);
    ``slots`` > S makes the caches the S-position prefix of a longer one,
    as the layers pass them (a batch stride that is not S·n·e).  With
    ``window`` > 0, the window mode over an S-slot ring after positions
    0..ring_end-1 were written, the query at ring_end - 1."""
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ref
    q = rand((b, h, e), dtype, g)
    kc, vc = (rand((b, slots or S, n, e), dtype, g)[:, :S] for _ in range(2))
    lens = torch.tensor(lengths or [S] * b, dtype=torch.int32, device="cuda")
    wm, mask = {}, None
    fewest = min(lengths or [S])
    if window > 0:
        wm = dict(kv_positions=ref.ring_positions(S, ring_end, "cuda"),
                  window=window,
                  q_pos=torch.full((b,), ring_end - 1, dtype=torch.int32,
                                   device="cuda"))
        # SDPA's boolean mask (b, 1, 1, S): the same visible slots
        mask = ref.visible(wm["q_pos"][:, None], wm["kv_positions"],
                           window)[:, None]
        fewest = min(fewest, int(mask.sum(-1).min()))

    def library():      # SDPA over the (b, n, S, e) view: all rows length S
        return F.scaled_dot_product_attention(
            q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]
    bnd = bound_ms(k1.bytes_moved(q, kc, lens, **wm),
                   (k1.flops(q, lens, S, **wm), dtype))
    return dict(kernel=lambda: k1.run(q, kc, vc, lens, nsplit, **wm),
                plain=lambda: ref.decode_attention_ref(q, kc, vc, lens, **wm),
                library=library if lengths is None else None, bound=bnd,
                tol=attention_tol(dtype, fewest))


def flash_case(b, sq, h, sk, n, e, dtype, g, causal=True, q_offset=0,
               kv_len=None, window=0, return_lse=False, ev=None,
               scale=None):
    """With ``window`` > 0, the window mode over an sk-slot ring after
    positions 0..q_offset+sq-1 were written (the chunk's own slots
    included, as the model writes them before it attends).  With
    ``return_lse``, the training forward (FlashAttentionFn's): the output
    and the LSE, held to ``ref.flash_attention_lse_ref``'s (the output
    within the forward's limit, the LSE within LSE_TOL); the LSE's bytes
    count in the bound, and the yardstick stays SDPA's forward (its LSE is
    internal to it).  ``ev`` and ``scale``: values ev wide and the scores'
    scale, DeepSeek's naive MLA form at (192, 128) (SDPA given the same
    ``scale``)."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ref
    ev = e if ev is None else ev
    q = rand((b, sq, h, e), dtype, g)
    k, v = rand((b, sk, n, e), dtype, g), rand((b, sk, n, ev), dtype, g)
    kv_len = sk if kv_len is None else kv_len
    wm = {}
    if window > 0:
        wm = dict(window=window, kv_positions=ref.ring_positions(
            sk, q_offset + sq, "cuda"))
    # SDPA's is_causal is top-left aligned, i.e. q_offset 0; otherwise a
    # boolean mask
    plain_causal = causal and q_offset == 0 and kv_len == sk and not wm
    mask = None
    if wm:
        mask = ref.visible(torch.arange(sq, device="cuda") + q_offset,
                           wm["kv_positions"], window, causal)
    elif causal and not plain_causal:
        mask = (torch.arange(sq, device="cuda")[:, None] + q_offset
                >= torch.arange(sk, device="cuda")[None])
    if kv_len < sk:
        valid = torch.arange(sk, device="cuda")[None] < kv_len
        mask = valid if mask is None else mask & valid
    fewest = (int(mask.sum(-1).min()) if mask is not None
              else 1 if causal else kv_len)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=plain_causal, scale=scale,
            enable_gqa=True).transpose(1, 2)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, **wm)
    if scale is not None:
        kw["scale"] = scale
    lse_bytes = 4 * b * h * sq if return_lse else 0
    bnd = bound_ms(k2.bytes_moved(q, k, kv_len, causal=causal,
                                  q_offset=q_offset, ev=ev, **wm)
                   + lse_bytes,
                   (k2.flops(q, kv_len, causal, q_offset, ev=ev, **wm),
                    dtype))
    if return_lse:
        return dict(kernel=lambda: k2.flash_attention(q, k, v, **kw,
                                                      return_lse=True),
                    plain=lambda: ref.flash_attention_lse_ref(q, k, v, **kw),
                    library=library, bound=bnd, pair=True,
                    tols=(attention_tol(dtype, fewest), LSE_TOL))
    return dict(kernel=lambda: k2.flash_attention(q, k, v, **kw),
                plain=lambda: ref.flash_attention_ref(q, k, v, **kw),
                library=library, bound=bnd, tol=attention_tol(dtype, fewest))


def mla_decode_case(b, h, S, dtype, g, lengths=None, nsplit=None,
                    slots=None):
    """K1's MLA mode: h heads over the S-row prefix of a latent cache
    (b, slots, 576), n = 1, values its first 512 columns.

    The MLA kernels keep the probabilities in f32, and deepseek's rows
    are peaked, so in bf16 the plain version's own rounding of the
    normalised probabilities (up to about 7.5e-3 off the exact output at
    |out| near 1) is what a comparison with it measures.  So the kernel
    is held to the plain version within TOL and, tighter, to ``exact``
    (the plain version with f64 values, whose probabilities are not
    rounded) within ``attention_tol``."""
    from repro_torch.kernels import decode_attention as k1
    from repro_torch.kernels import ref
    q = rand((b, h, 576), dtype, g)
    k = rand((b, slots or S, 576), dtype, g)[:, :S, None]
    v = k[..., :512]
    lens = torch.tensor(lengths or [S] * b, dtype=torch.int32, device="cuda")

    def library():      # SDPA over the (b, 1, S, e) views
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            scale=MLA_SCALE, enable_gqa=True)[:, :, 0]
    bnd = bound_ms(k1.mla_bytes_moved(q, k, v, lens),
                   (k1.mla_flops(q, v, lens, S), dtype))
    return dict(kernel=lambda: k1.run_mla(q, k, v, lens, scale=MLA_SCALE,
                                          nsplit=nsplit),
                plain=lambda: ref.decode_attention_ref(q, k, v, lens,
                                                       scale=MLA_SCALE),
                exact=lambda: ref.decode_attention_ref(
                    q, k, v.double(), lens, scale=MLA_SCALE),
                library=library if lengths is None else None, bound=bnd,
                tol=TOL[dtype],
                exact_tol=attention_tol(dtype, min(lengths or [S])))


def mla_flash_case(b, sq, h, sk, n, e, ev, dtype, g, causal=True,
                   q_offset=0, kv_len=None):
    """K2's MLA mode, the absorbed form (e 576, ev 512: n = 1, values the
    keys' first columns); held to the plain version and to the near-exact
    one as mla_decode_case says."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ref
    q = rand((b, sq, h, e), dtype, g)
    k = rand((b, sk, n, e), dtype, g)
    v = k[..., :ev]
    kv_len = sk if kv_len is None else kv_len
    qpos = torch.arange(sq, device="cuda") + q_offset
    mask = torch.arange(sk, device="cuda")[None] < kv_len
    if causal:
        mask = mask & (qpos[:, None] >= torch.arange(sk, device="cuda"))
    fewest = int(mask.sum(-1).min())

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=MLA_SCALE, enable_gqa=True).transpose(1, 2)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              scale=MLA_SCALE)
    bnd = bound_ms(k2.mla_bytes_moved(q, k, v, kv_len, causal=causal,
                                      q_offset=q_offset),
                   (k2.mla_flops(q, v, kv_len, causal, q_offset), dtype))
    return dict(kernel=lambda: k2.flash_attention(q, k, v, **kw),
                plain=lambda: ref.flash_attention_ref(q, k, v, **kw),
                exact=lambda: ref.flash_attention_ref(q, k, v.double(),
                                                      **kw),
                library=library, bound=bnd, tol=TOL[dtype],
                exact_tol=attention_tol(dtype, fewest))


def backward_case(b, sq, h, sk, n, e, dtype, g, causal=True, q_offset=0,
                  kv_len=None, ev=None, scale=None):
    """K2's backward at one shape: q, k, v and dO random, O and the LSE
    from K2's forward (``flash_attention(..., return_lse=True)``, what
    FlashAttentionFn saves); the yardstick is ``torch.autograd.grad``
    through SDPA with ``enable_gqa`` (a boolean mask off q_offset 0 or
    kv_len < sk; ``scale`` where given), the backward alone.  ``fwd`` is
    ((K2's O, its LSE), the plain version's), and ``fwd_tols`` their
    limits.  ``ev``, ``scale``: as :func:`flash_case`'s."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import flash_attention_bwd as kb
    from repro_torch.kernels import ref
    ev = e if ev is None else ev
    q, do = rand((b, sq, h, e), dtype, g), rand((b, sq, h, ev), dtype, g)
    k, v = rand((b, sk, n, e), dtype, g), rand((b, sk, n, ev), dtype, g)
    kv_len = sk if kv_len is None else kv_len
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    if scale is not None:
        kw["scale"] = scale
    o, lse = k2.flash_attention(q, k, v, **kw, return_lse=True)
    plain_causal = causal and q_offset == 0 and kv_len == sk
    mask = None
    if causal and not plain_causal:
        mask = (torch.arange(sq, device="cuda")[:, None] + q_offset
                >= torch.arange(sk, device="cuda")[None])
    if kv_len < sk:
        valid = torch.arange(sk, device="cuda")[None] < kv_len
        mask = valid if mask is None else mask & valid
    fewest = (int(mask.sum(-1).min()) if mask is not None
              else 1 if causal else kv_len)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                         is_causal=plain_causal,
                                         scale=scale, enable_gqa=True)
    dout = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)
    bnd = bound_ms(kb.bytes_moved(q, k, lse, v),
                   (kb.flops(q, kv_len, causal, q_offset, ev=ev), dtype))
    return dict(kernel=lambda: kb.flash_attention_bwd(q, k, v, o, do, lse,
                                                      **kw),
                plain=lambda: ref.flash_attention_bwd_ref(q, k, v, o, do,
                                                          lse, **kw),
                library=library, bound=bnd, tol=BWD_TOL[dtype], pair=True,
                scaled=True,
                fwd=((o, lse), lambda: ref.flash_attention_lse_ref(q, k, v,
                                                                   **kw)),
                fwd_tols=(attention_tol(dtype, fewest), LSE_TOL))


def topk_case(nq, N, d, k, g, queries=None, corpus=None):
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_retrieval as k3
    q = (F.normalize(rand((nq, d), torch.float32, g), dim=-1)
         if queries is None else queries)
    c = (F.normalize(rand((N, d), torch.float32, g), dim=-1)
         if corpus is None else corpus)
    bnd = bound_ms(k3.bytes_moved(q, c, k), (k3.flops(q, c), torch.float32))
    return dict(kernel=lambda: k3.topk_retrieval(q, c, k),
                plain=lambda: ref.topk_retrieval_ref(q, c, k),
                library=lambda: torch.topk(q @ c.T, k),
                bound=bnd, tol=1e-4, scores=lambda: q @ c.T)


def ssd_case(b, nc, Q, H, P, N, dtype, broadcast, g, kernel=None,
             splits=None):
    """zamba2's decays (A = -linspace(1, 16, H)); with ``broadcast`` B and
    C are one group expanded to every head (stride 0), as the model
    passes them.  ``kernel`` and ``splits`` force the launch (else
    ``ssd_chunk.plan``'s)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as k5
    x = rand((b, nc, Q, H, P), dtype, g)
    dt = F.softplus(rand((b, nc, Q, H), torch.float32, g))
    dA = dt * -torch.linspace(1.0, 16.0, H, device="cuda")
    G = 1 if broadcast else H
    B, C = (rand((b, nc, Q, G, N), dtype, g) for _ in range(2))
    if broadcast:
        B, C = (t.expand(-1, -1, -1, H, -1) for t in (B, C))
    args = (x, dt, B, C, dA)
    # the scores C·Bᵀ at the inputs' type's peak, the rest on f32 operands
    bnd = bound_ms(k5.bytes_moved(*args), *k5.flops(x, B))
    return dict(kernel=lambda: k5.run(*args, kernel=kernel, splits=splits),
                plain=lambda: ref.ssd_chunk_ref(*args), args=args,
                library=None, bound=bnd, tol=SSD_TOL, pair=True)


SSD_BWD_NAMES = ("dx", "ddt", "dB", "dC", "ddA")


def ssd_backward_case(b, nc, Q, H, P, N, dtype, broadcast, g, kernel=None):
    """K5's backward at one shape: ``ssd_case``'s inputs (zamba2's
    decays, B and C one group broadcast to every head or a group each)
    and f32 cotangents dy, dS; ``kernel`` forces a route (else
    ``ssd_chunk_bwd.plan``'s).  Held to (``want``): dx, dB and dC to the
    plain version at the input type's BWD_TOL, ddt and ddA (f32 outputs)
    to the plain version evaluated in f64 (``f64``) at f32's.  No
    library call computes this function."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk_bwd as k5b
    args = ssd_case(b, nc, Q, H, P, N, dtype, broadcast, g)["args"]
    dy = rand((b, nc, Q, H, P), torch.float32, g)
    dS = rand((b, nc, H, N, P), torch.float32, g)
    full = (*args, dy, dS)

    def plain():
        return ref.ssd_chunk_bwd_ref(*full)

    def f64():
        return ref.ssd_chunk_bwd_ref(*(t.double() for t in full))

    def want():
        p, e = plain(), f64()
        return tuple(e[i] if n in ("ddt", "ddA") else p[i]
                     for i, n in enumerate(SSD_BWD_NAMES))
    f32 = BWD_TOL[torch.float32]
    bnd = bound_ms(k5b.bytes_moved(*args), *k5b.flops(args[0], args[2]))
    return dict(kernel=(lambda: k5b.ssd_chunk_bwd(*full)) if kernel is None
                else (lambda: k5b.run(*full, kernel=kernel)), plain=plain,
                want=want, f64=f64, library=None, bound=bnd, pair=True,
                scaled=True, tols=tuple(f32 if n in ("ddt", "ddA")
                                        else BWD_TOL[dtype]
                                        for n in SSD_BWD_NAMES))


def int8_case(M, K, N, out_dtype, g):
    """Quantized normal inputs; the library yardstick is ``torch._int_mm``
    (cuBLASLt's int8 product, int32 out, without the dequant epilogue)
    where its shape rules allow it (M > 16, K and N multiples of 8)."""
    from repro_torch.kernels import int8_matmul as k4
    from repro_torch.kernels import ref
    xq, sx = k4.quantize_int8(rand((M, K), torch.float32, g), axis=1)
    wq, sw = k4.quantize_int8(rand((K, N), torch.float32, g), axis=0)
    library = None
    if M > 16 and K % 8 == 0 and N % 8 == 0:
        def library():
            return torch._int_mm(xq, wq)
    bnd = bound_ms(k4.bytes_moved(xq, wq, out_dtype),
                   (k4.ops(xq, wq), torch.int8))
    return dict(kernel=lambda: k4.int8_matmul(xq, wq, sx, sw, out_dtype),
                plain=lambda: ref.int8_matmul_ref(xq, wq, sx, sw, out_dtype),
                library=library, bound=bnd, tol=0.0)


def adamw_case(state_dtype, leaves, g, step=5):
    """AdamW's kernel pair over a leaf set: ``leaves`` is ((shape,
    parameter type, gradient type, count), ...), the moments are of
    ``state_dtype``; at ``step``, the gradients N(0, 1e-3), so the clip
    is engaged from 10^6 parameters on.  The kernel, the plain version
    (``optimizer.global_norm`` and ``plain_update``) and the library
    update the state in place, each timing on what the last left (finite
    at lr 1e-3).  ``check`` runs the kernel and the plain loop from one
    state: p, m and v bit-equal at the kernel's clip scale, its norm
    within rtol 1e-6 of ``global_norm``.  The library is
    ``torch._fused_adamw_``, which the port never calls: moments of the
    parameters' type made at its first call, no clip, so 14 bytes a bf16
    parameter where the kernel moves 24 at f32 moments."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.training import optimizer
    cfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=1)
    shapes = [(s, pt, gt) for s, pt, gt, n in leaves for _ in range(n)]
    p = [(2e-2 * rand(s, torch.float32, g)).to(pt) for s, pt, _ in shapes]
    gr = [(1e-3 * rand(s, torch.float32, g)).to(gt) for s, _, gt in shapes]
    m = [(1e-3 * rand(s, torch.float32, g)).to(state_dtype)
         for s, _, _ in shapes]
    v = [(1e-6 * torch.rand(s, generator=g, device="cuda")).to(state_dtype)
         for s, _, _ in shapes]
    st = torch.tensor(step, dtype=torch.int32, device="cuda")
    lr = optimizer._schedule(cfg, st)
    bc1 = 1 - torch.pow(cfg.b1, st.float())
    bc2 = 1 - torch.pow(cfg.b2, st.float())
    names = [str(i) for i in range(len(p))]
    gd = dict(zip(names, gr))

    def kernel():
        return kadamw.adamw(p, gr, m, v, lr, bc1, bc2, b1=cfg.b1, b2=cfg.b2,
                            eps=cfg.eps, weight_decay=cfg.weight_decay,
                            grad_clip=cfg.grad_clip,
                            norm_floor=optimizer.NORM_FLOOR)

    def plain():
        optimizer.plain_update(list(zip(names, p)), gd, dict(zip(names, m)),
                               dict(zip(names, v)), optimizer.clip_scale(
                                   optimizer.global_norm(gd), cfg), lr, bc1,
                               bc2, cfg)

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    def check():
        # the state before the step waits on the host: a second copy on
        # the card would not fit beside the moe train path's
        before = [[t.cpu() for t in ts] for ts in (p, m, v)]
        gnorm = kernel()
        got, want = float(gnorm), float(optimizer.global_norm(gd))
        assert abs(got - want) <= 1e-6 * want, ("adamw norm", got, want)
        scale = optimizer.clip_scale(gnorm, cfg)
        for i, ours in enumerate(zip(p, m, v)):
            pi, mi, vi = (ts[i].cuda() for ts in before)
            k = names[i]
            optimizer.plain_update([(k, pi)], gd, {k: mi}, {k: vi}, scale,
                                   lr, bc1, bc2, cfg)
            for what, a, b in zip("pmv", ours, (pi, mi, vi)):
                assert torch.equal(bits(a), bits(b)), (
                    f"adamw: {what} of leaf {i} {tuple(a.shape)} differs "
                    f"from the plain loop's")
        return 0.0

    fused = {}

    def library():
        if not fused:
            for pi, gi in zip(p, gr):
                grp = fused.setdefault(pi.dtype, ([], [], [], [], []))
                for lst, t in zip(grp, (pi, gi.to(pi.dtype),
                                        torch.zeros_like(pi),
                                        torch.zeros_like(pi),
                                        torch.ones((), device="cuda"))):
                    lst.append(t)
        for ps, gs, ms, vs, steps in fused.values():
            torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=cfg.lr,
                                beta1=cfg.b1, beta2=cfg.b2,
                                weight_decay=cfg.weight_decay, eps=cfg.eps,
                                amsgrad=False, maximize=False)

    bnd = bound_ms(kadamw.bytes_moved(p, gr, m, v),
                   (kadamw.flops(p), torch.float32))
    return dict(kernel=kernel, plain=plain, library=library, bound=bnd,
                check=check, timers={"plain": paced, "library": paced})


def measure(case):
    """Device and host-paced times of the kernel, the plain version and
    the library yardstick, beside the bound (:func:`timed`, or the case's
    ``timers``)."""
    t = {}
    timers = case.get("timers", {})
    for key, prefix in (("kernel", ""), ("plain", "plain_"),
                        ("library", "library_")):
        dev, host = (timers.get(key, timed)(case[key]) if case[key]
                     else (None, None))
        t[f"{prefix}ms"], t[f"{prefix}host_ms"] = dev, host
    t["bound_ms"], t["bound_by"] = case["bound"]
    return t


def fmt(t):
    lib = "—" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
    return (f"kernel {t['ms']:.4f} ms (host-paced {t['host_ms']:.4f}) | "
            f"plain {t['plain_ms']:.4f} ms | library {lib} ms | "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']})")



class RingFill:
    """The fill of the ring a window-mode K1 call reads: the query's
    position + 1, clamped at a full ring, where every slot is visible.
    ShapeLog reads it after the run, once the device is idle, so that the
    timed run waits on no device value (the layers make a new ``q_pos``
    for every call, so it still holds the call's position then)."""

    def __init__(self, q_pos, slots):
        self.q_pos, self.slots = q_pos, slots

    def read(self):
        return min(int(self.q_pos[0]) + 1, self.slots)


def is_mla_key(key):
    return key[0] == "mla"


def _k1_key(q, kc, vc, lengths, *, kv_positions=None, q_pos=None,
            window=0, scale=None):
    """A lengths-mode call reads every row in full (the layers pass the
    valid prefix); a window-mode call is the model's ring, whose state
    follows from the query's position (a RingFill); an MLA-mode call is
    keyed "mla" with its value width."""
    b, h, e = q.shape
    if scale is not None or vc.shape[-1] != e:
        return ("mla", b, h, kc.shape[2], kc.shape[1], e, vc.shape[-1],
                q.dtype)
    key = (b, h, kc.shape[2], kc.shape[1], e, q.dtype)
    if window > 0:
        key += (window, RingFill(q_pos, kc.shape[1]))
    return key


def _k2_key(q, k, v, *, causal=True, q_offset=0, kv_len=None,
            kv_positions=None, window=0, scale=None, return_lse=False):
    """A ring's state follows from q_offset: from q_offset = sk - sq on the
    ring is full and each query sees the same number of slots, so the
    offset is clamped there.  An MLA-mode call is keyed "mla", the naive
    MLA form (the generic route with values narrower than keys and a
    scale) "naive", the training forward (``return_lse``) "lse"."""
    from repro_torch.kernels import flash_attention as k2
    b, sq, h, e = q.shape
    sk = k.shape[1]
    if k2.is_mla(k, v, scale):
        return ("mla", b, sq, h, sk, k.shape[2], e, v.shape[-1], q.dtype,
                causal, q_offset, kv_len)
    if v.shape[-1] != e or scale is not None:     # the naive MLA form
        return ("naive", return_lse, b, sq, h, sk, k.shape[2], e, q.dtype,
                causal, q_offset, kv_len, v.shape[-1], scale)
    if return_lse:
        return ("lse", b, sq, h, sk, k.shape[2], e, q.dtype, causal,
                q_offset, kv_len)
    if window > 0:
        return (b, sq, h, sk, k.shape[2], e, q.dtype, causal,
                min(q_offset, sk - sq), kv_len, window)
    return (b, sq, h, sk, k.shape[2], e, q.dtype, causal, q_offset, kv_len)


def _k3_key(queries, corpus, k):
    return (queries.shape[0], corpus.shape[0], queries.shape[1], k)


def _k4_key(x, w, sx, sw, out_dtype=torch.bfloat16):
    return (x.shape[0], x.shape[1], w.shape[1], out_dtype)


def _k5_key(x, dt, B, C, dA):
    return (*x.shape, B.shape[-1], x.dtype, B.stride(3) == 0)


def _k5b_key(x, dt, B, C, dA, dy, dS):
    return _k5_key(x, dt, B, C, dA)


def _adamw_key(params, grads, m, v, *_, **__):
    """A leaf set: the moments' type and each (shape, parameter type,
    gradient type) with its count, in the order first seen."""
    runs = collections.Counter((tuple(p.shape), p.dtype, g.dtype)
                               for p, g in zip(params, grads))
    return (m[0].dtype, tuple((*k, n) for k, n in runs.items()))


def train_leaf_key(path):
    """:func:`_adamw_key` of a train path's model
    (``profile_serve.TRAIN_PATHS``) at its width on the card, from a meta
    build: gradients of the parameters' types, moments of AdamW's
    default state type."""
    from repro_torch import torch_dtype
    from repro_torch.launch import profile_serve
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig
    cfg = profile_serve.train_config(torch.device("cuda"), path)
    ps = list(build_model(cfg, "meta").init(0, trainable=True).parameters())
    state = torch.empty((), dtype=torch_dtype(AdamWConfig().state_dtype))
    return _adamw_key(ps, ps, [state], None)


def _adamw_case(key, g):
    """A key, or ("path", <train path>) for :func:`train_leaf_key`'s."""
    return adamw_case(*(train_leaf_key(key[1]) if key[0] == "path"
                        else key), g)


def _kb_key(q, k, v, o, do, lse, *, causal, q_offset=0, kv_len=None,
            scale=None):
    b, sq, h, e = q.shape
    return (b, sq, h, k.shape[1], k.shape[2], e, q.dtype, causal, q_offset,
            kv_len, v.shape[-1], scale)


# per kernel of repro_torch.kernels.ops.KERNELS: the shape key of one
# wrapper call, and the case that replays a key on fresh random inputs
def _mla_k1_case(key, g):
    _, b, h, n, S, e, ev, dtype = key
    assert (n, e, ev) == (1, 576, 512), key
    return mla_decode_case(b, h, S, dtype, g)


def _mla_k2_case(key, g):
    _, b, sq, h, sk, n, e, ev, dtype, causal, q_offset, kv_len = key
    return mla_flash_case(b, sq, h, sk, n, e, ev, dtype, g, causal=causal,
                          q_offset=q_offset, kv_len=kv_len)


def _k2_case(key, g):
    if key[0] == "naive":
        (_, lse, b, sq, h, sk, n, e, dtype, causal, q_offset, kv_len, ev,
         scale) = key
        return flash_case(b, sq, h, sk, n, e, dtype, g, causal, q_offset,
                          kv_len, return_lse=lse, ev=ev, scale=scale)
    if key[0] == "lse":
        return flash_case(*key[1:8], g, *key[8:], return_lse=True)
    return flash_case(*key[:7], g, *key[7:])


REPLAY = {
    "decode_attention": (_k1_key, lambda key, g: decode_case(
        *key[:6], g, window=key[6], ring_end=key[7]) if len(key) > 6
        else decode_case(*key, g)),
    MLA_ROW["decode_attention"]: (_k1_key, _mla_k1_case),
    MLA_ROW["flash_attention"]: (_k2_key, _mla_k2_case),
    "flash_attention": (_k2_key, _k2_case),
    "topk_retrieval": (_k3_key, lambda key, g: topk_case(*key, g)),
    "int8_matmul": (_k4_key, lambda key, g: int8_case(*key, g)),
    "ssd_chunk": (_k5_key, lambda key, g: ssd_case(*key, g)),
    "flash_attention_bwd": (_kb_key, lambda key, g: backward_case(
        *key[:7], g, causal=key[7], q_offset=key[8], kv_len=key[9],
        ev=key[10], scale=key[11])),
    "ssd_chunk_bwd": (_k5b_key, lambda key, g: ssd_backward_case(*key, g)),
    "adamw": (_adamw_key, _adamw_case),
}


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------

# the most frequent shape key of each kernel row on each path of PERF.md
# section 4, as chip_smoke.py's ShapeLog recorded them there (REPLAY's key
# functions; printed by its bench phase); K4 runs on no path and is timed
# at one zamba2 projection's shape; AdamW's key is a train path's leaf
# set, written ("path", <train path>) and built at the call
PATH_KEYS: Dict[str, Dict[str, tuple]] = {
    "w2_isolated": {
        "flash_attention": (1, 16, 32, 16, 8, 128, torch.bfloat16, True, 0, None),
        "decode_attention": (1, 32, 8, 17, 128, torch.bfloat16),
        "topk_retrieval": (1, 128, 1024, 116),
    },
    "zamba2_engine": {
        "ssd_chunk": (1, 1, 1, 64, 64, 64, torch.bfloat16, True),
        "flash_attention": (1, 128, 32, 128, 32, 64, torch.bfloat16, True, 0, None),
        "decode_attention": (1, 32, 32, 65, 64, torch.bfloat16),
    },
    "zamba2_long": {
        "ssd_chunk": (1, 1, 128, 64, 64, 64, torch.bfloat16, True),
        "flash_attention": (1, 128, 32, 4096, 32, 64, torch.bfloat16, True, 3968,
                            None, 4096),
        "decode_attention": (1, 32, 32, 4096, 64, torch.bfloat16, 4096, 4096),
    },
    "whisper": {
        "flash_attention": (1, 1500, 20, 1500, 20, 64, torch.bfloat16, False, 0,
                            None),
        "decode_attention": (1, 20, 20, 1500, 64, torch.bfloat16),
    },
    "vlm": {
        "flash_attention": (1, 16, 64, 16, 8, 128, torch.bfloat16, True, 0, None),
        "decode_attention": (1, 64, 8, 1601, 128, torch.bfloat16),
    },
    "deepseek_engine": {
        MLA_ROW["flash_attention"]: ("mla", 1, 128, 128, 128, 1, 576, 512,
                                     torch.bfloat16, True, 0, None),
        MLA_ROW["decode_attention"]: ("mla", 1, 128, 1, 65, 576, 512,
                                      torch.bfloat16),
    },
    "train": {
        "flash_attention": ("lse", 8, 256, 16, 256, 16, 64, torch.bfloat16,
                            True, 0, None),
        "flash_attention_bwd": (8, 256, 16, 256, 16, 64, torch.bfloat16,
                                True, 0, None, 64, None),
        "adamw": ("path", "train"),
    },
    "train_hybrid": {
        "ssd_chunk": (4, 2, 256, 64, 64, 64, torch.bfloat16, True),
        "flash_attention": ("lse", 4, 512, 32, 512, 32, 64, torch.bfloat16,
                            True, 0, None),
        "ssd_chunk_bwd": (4, 2, 256, 64, 64, 64, torch.bfloat16, True),
        "flash_attention_bwd": (4, 512, 32, 512, 32, 64, torch.bfloat16,
                                True, 0, None, 64, None),
        "adamw": ("path", "train-hybrid"),
    },
    "train_moe": {
        "flash_attention": ("naive", True, 2, 512, 128, 512, 128, 192,
                            torch.bfloat16, True, 0, None, 128, MLA_SCALE),
        "flash_attention_bwd": (2, 512, 128, 512, 128, 192, torch.bfloat16,
                                True, 0, None, 128, MLA_SCALE),
        "adamw": ("path", "train-moe"),
    },
    "none": {"int8_matmul": (128, 2048, 4096, torch.bfloat16)},
}

COLUMNS = ("name,path,device_us,host_us,bound_us,bound_by,plain_us,"
           "library_us")


def row(name: str, path: str, key: tuple,
        g: Optional[torch.Generator] = None) -> Dict[str, object]:
    """One kernel row at ``key`` on fresh random inputs: times in µs."""
    g = g or torch.Generator(device="cuda").manual_seed(1)
    t = measure(REPLAY[name][1](key, g))
    us = {f: None if t[f] is None else 1e3 * t[f]
          for f in ("ms", "host_ms", "plain_ms", "bound_ms", "library_ms")}
    return dict(name=name, path=path, device_us=us["ms"],
                host_us=us["host_ms"], bound_us=us["bound_ms"],
                bound_by=t["bound_by"], plain_us=us["plain_ms"],
                library_us=us["library_ms"])


def run(csv: Callable[[str], object] = print,
        keys: Optional[Dict[str, Dict[str, tuple]]] = None):
    """Times every (path, kernel) of ``keys`` (else :data:`PATH_KEYS`) and
    prints a CSV row each through ``csv``; -> the rows."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel bench times the port's CUDA kernels "
                           "and needs an NVIDIA GPU")
    g = torch.Generator(device="cuda").manual_seed(1)
    csv(COLUMNS)
    rows = []
    for path, kernels in (keys or PATH_KEYS).items():
        for name, key in kernels.items():
            r = row(name, path, key, g)
            csv(",".join("" if r[c] is None else
                         f"{r[c]:.2f}" if isinstance(r[c], float)
                         else str(r[c]) for c in COLUMNS.split(",")))
            rows.append(r)
    return rows


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# {torch.cuda.get_device_name(0)}" if torch.cuda.is_available()
          else "# no CUDA device", file=sys.stderr)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
