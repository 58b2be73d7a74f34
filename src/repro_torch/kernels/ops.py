"""Public kernel entry points, the table of the port's kernels, the
table of its backward kernels and the table of its optimizer kernels.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``);
a CUDA tensor goes to the hand-written kernel, which raises on anything it
does not take.  There is no fallback from one to the other.  A tensor on
the meta device (the dry-run, ``launch/dryrun.py``) gets empty meta
outputs of the kernel's result shapes (the ``meta_*`` functions): no
plain version runs, so no score matrix is formed, and on the gradient
route the meta call goes through ``FlashAttentionFn`` and ``SsdChunkFn``
as the card's does.  Any other device raises.

A ``DTensor`` (the dry-run's production meshes) runs K1, K2 and K5 on
this rank's shards (``models.sharding.run_local``): batch rows over the
data axes, heads over ``model`` where the query and key/value head counts
both divide it, every other dim whole.

AdamW's step is a kernel too (:func:`adamw`, ``kernels/adamw.py``, the
one row of ``OPTIMIZER_KERNELS``): it ports no TPU kernel but what XLA
makes of the JAX package's ``adamw_update``.  The card runs it and meta
counts it; the CPU runs the optimizer's plain loop and never comes here
(``training/optimizer.py``).

Observers (``launch/op_cost.py``'s counter) see each kernel call as one
operation: :func:`observed` hands them the kernel's name, its work (the
wrapper's ``flops``, as (operations, type) pairs) and its bytes (the
wrapper's ``bytes_moved``), forward and backward, on the card and on
meta alike, and marks the call's own tensor operations as inside it.

Gradients: on the CPU the plain versions are differentiated by
autograd.  On the card, when grad mode is on and an input requires a
gradient, ``flash_attention`` with no window and outside MLA mode (every
pair of ``flash_attention.HEAD_DIMS``, DeepSeek's naive MLA form at keys
192, values 128 with its ``scale`` included) runs
``flash_attention.FlashAttentionFn``, whose backward is K2's backward
kernel, and ``ssd_chunk`` runs ``ssd_chunk.SsdChunkFn``, whose backward
is K5's backward kernel; every other kernel call raises a
``RuntimeError`` naming the kernel (K1, K3, K4, K2's window mode and its
MLA mode, the absorbed form over a latent cache, which no training path
runs): their outputs carry no ``grad_fn``, so a gradient would silently
stop at them.  Under ``no_grad`` nothing is guarded.
"""
from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import int8_matmul as _int8
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import ssd_chunk_bwd as _ssd_bwd
from repro_torch.kernels import topk_retrieval as _topk


@dataclass(frozen=True)
class Kernel:
    """One hand-written kernel.  ``module`` holds the wrapper (named like
    the kernel) and its launch counter; ``source`` is ``csrc/<name>.cu``;
    ``symbols`` are its ``__global__`` functions, as a device trace names
    them."""
    name: str
    module: ModuleType
    # the TPU kernel it ports, file:line; an OPTIMIZER_KERNELS row ports
    # none and names the JAX function whose XLA code it replaces
    replaces: str
    symbols: Tuple[str, ...]

    @property
    def source(self) -> str:
        """Path of the CUDA source, relative to the repository root."""
        return f"src/repro_torch/kernels/csrc/{self.name}.cu"


KERNELS = (
    Kernel("decode_attention", _decode,
           "src/repro/kernels/decode_attention.py:25",
           ("decode_attn", "decode_mla", "decode_mla_wgmma",
            "decode_mla_combine")),
    Kernel("flash_attention", _flash,
           "src/repro/kernels/flash_attention.py:26",
           ("flash_fwd_wgmma", "flash_combine", "flash_fwd", "flash_mla",
            "flash_mla_wgmma", "flash_mla_combine")),
    Kernel("topk_retrieval", _topk,
           "src/repro/kernels/topk_retrieval.py:22",
           ("topk_partial", "topk_merge")),
    Kernel("int8_matmul", _int8,
           "src/repro/kernels/int8_matmul.py:22",
           ("int8_mm_wgmma", "int8_mm")),
    Kernel("ssd_chunk", _ssd,
           "src/repro/kernels/mamba2_scan.py:23",
           ("ssd_decode", "ssd_chunk_mma", "ssd_chunk_fwd")),
)


@dataclass(frozen=True)
class BackwardKernel:
    """One hand-written backward kernel: the gradient of the ``KERNELS``
    row ``differentiates``.  ``autodiff_of`` is the JAX function
    (file:line) whose XLA autodiff it replaces: the JAX package has no
    backward Pallas kernel.  ``module`` holds the wrapper (named like the
    kernel) and its own launch counter."""
    name: str
    module: ModuleType
    differentiates: str
    autodiff_of: str
    symbols: Tuple[str, ...]

    @property
    def source(self) -> str:
        return f"src/repro_torch/kernels/csrc/{self.name}.cu"


BACKWARD_KERNELS = (
    BackwardKernel("flash_attention_bwd", _flash_bwd, "flash_attention",
                   "src/repro/models/layers.py:116",
                   ("flash_bwd_prep", "flash_bwd_dkdv_wgmma",
                    "flash_bwd_dq_wgmma", "flash_bwd_delta", "flash_bwd_dkdv",
                    "flash_bwd_dq", "flash_bwd_sum")),
    BackwardKernel("ssd_chunk_bwd", _ssd_bwd, "ssd_chunk",
                   "src/repro/models/ssm.py:78",
                   ("ssd_bwd_keys_mma", "ssd_bwd_queries_mma",
                    "ssd_bwd_tiles", "ssd_bwd_finish")),
)


OPTIMIZER_KERNELS = (
    Kernel("adamw", _adamw, "src/repro/training/optimizer.py:60",
           ("adamw_sumsq", "adamw_step")),
)


def _wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if a kernel without a backward is asked for a gradient."""
    if _wants_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward kernel: an input requires a gradient "
            f"under grad mode, and the kernel's output would drop it "
            f"(run under torch.no_grad(), or train this path on the CPU)")


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def is_dtensor(t) -> bool:
    """A ``DTensor`` (none can exist before its module is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _route(t: torch.Tensor) -> str:
    """"meta" (the kernel's result shapes), "card" (the kernel) or "cpu"
    (the plain version)."""
    if t.is_meta:
        return "meta"
    return "card" if _on_card(t) else "cpu"


# ---------------------------------------------------------------------------
# observers of kernel calls
# ---------------------------------------------------------------------------

Work = List[Tuple[int, object]]          # (operations, the type pricing them)
_OBSERVERS: List[object] = []


def add_observer(obs) -> None:
    """``obs.kernel_enter(name, work, nbytes)`` and ``obs.kernel_exit()``
    run around every kernel call until :func:`remove_observer`."""
    _OBSERVERS.append(obs)


def remove_observer(obs) -> None:
    _OBSERVERS.remove(obs)


@contextlib.contextmanager
def observed(name: str,
             cost: Callable[[], Tuple[Work, int]]) -> Iterator[None]:
    """Around one call of kernel ``name``; ``cost()`` -> (work, bytes) is
    evaluated only while an observer is registered."""
    if not _OBSERVERS:
        yield
        return
    work, nbytes = cost()
    seen = list(_OBSERVERS)
    for obs in seen:
        obs.kernel_enter(name, work, int(nbytes))
    try:
        yield
    finally:
        for obs in reversed(seen):
            obs.kernel_exit()


def _decode_cost(q, k_cache, v_cache, lengths, kv_positions, q_pos, window,
                 scale):
    """K1's work and bytes; on meta, where lengths and positions have no
    values, every cache row counts as visible."""
    S = k_cache.shape[1]
    if q.is_meta:
        lengths = torch.full((q.shape[0],), S, dtype=torch.int32)
        kv_positions = q_pos = None
        window = 0
    if scale is not None or v_cache.shape[-1] != k_cache.shape[-1]:
        return ([(_decode.mla_flops(q, v_cache, lengths, S), q.dtype)],
                _decode.mla_bytes_moved(q, k_cache, v_cache, lengths))
    wm = dict(kv_positions=kv_positions, q_pos=q_pos, window=window)
    return ([(_decode.flops(q, lengths, S, **wm), q.dtype)],
            _decode.bytes_moved(q, k_cache, lengths, **wm))


def _flash_cost(q, k, v, causal, q_offset, kv_len, kv_positions, window,
                scale, lse: bool):
    """K2's work and bytes (with ``lse``, the training forward's LSE
    written too); on meta a window's positions have no values, so every
    slot counts as visible."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    if _flash.is_mla(k, v, scale):
        return ([(_flash.mla_flops(q, v, kv_len, causal, q_offset),
                  q.dtype)],
                _flash.mla_bytes_moved(q, k, v, kv_len, causal=causal,
                                       q_offset=q_offset))
    wm = {}
    if window > 0 and not q.is_meta:
        wm = dict(kv_positions=kv_positions, window=window)
    elif window > 0:
        causal = False
    ev = v.shape[-1]
    extra = 4 * q.shape[0] * q.shape[2] * q.shape[1] if lse else 0
    return ([(_flash.flops(q, kv_len, causal, q_offset, ev=ev, **wm),
              q.dtype)],
            _flash.bytes_moved(q, k, kv_len, causal=causal,
                               q_offset=q_offset, ev=ev, **wm) + extra)


def flash_bwd_cost(q, k, v, lse, causal, q_offset, kv_len):
    """K2's backward's work and bytes."""
    kv_len = k.shape[1] if kv_len is None else kv_len
    return ([(_flash_bwd.flops(q, kv_len, causal, q_offset,
                               ev=v.shape[-1]), q.dtype)],
            _flash_bwd.bytes_moved(q, k, lse, v))


def ssd_bwd_cost(x, dt, B, C, dA):
    """K5's backward's work and bytes."""
    return _ssd_bwd.flops(x, B), _ssd_bwd.bytes_moved(x, dt, B, C, dA)


# ---------------------------------------------------------------------------
# the meta route: each kernel's result shapes, no data
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_flash_attention(q: torch.Tensor, v: torch.Tensor,
                         return_lse: bool = False):
    """K2's output (b, sq, h, v's width) in q's type [and its f32 LSE
    (b, h, sq)]."""
    b, sq, h, _ = q.shape
    out = _meta((b, sq, h, v.shape[-1]), q.dtype)
    return (out, _meta((b, h, sq), torch.float32)) if return_lse else out


def meta_flash_attention_bwd(q, k, v):
    """K2's backward's (dq, dk, dv), each in its input's shape and type."""
    return tuple(_meta(t.shape, t.dtype) for t in (q, k, v))


def meta_ssd_chunk(x: torch.Tensor, B: torch.Tensor):
    """K5's y (b, nc, Q, H, P) and chunk states (b, nc, H, N, P), f32."""
    b, nc, Q, H, Pd = x.shape
    return (_meta(x.shape, torch.float32),
            _meta((b, nc, H, B.shape[-1], Pd), torch.float32))


def meta_ssd_chunk_bwd(x, dt, B, C, dA):
    """K5's backward's dx, ddt, dB, dC (per head), ddA."""
    per_head = x.shape[:4] + B.shape[-1:]
    return (_meta(x.shape, x.dtype), _meta(dt.shape, torch.float32),
            _meta(per_head, x.dtype), _meta(per_head, x.dtype),
            _meta(dA.shape, torch.float32))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     kv_positions: Optional[torch.Tensor] = None,
                     q_pos: Optional[torch.Tensor] = None,
                     window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    if is_dtensor(q):
        from repro_torch.models.sharding import run_local
        return run_local(
            lambda q, kc, vc, ln, qp: decode_attention(
                q, kc, vc, ln, kv_positions=kv_positions, q_pos=qp,
                window=window, scale=scale),
            (q, k_cache, v_cache, lengths, q_pos),
            [(0, 1), (0, 2), (0, 2), (0, None),
             None if q_pos is None else (0, None)],
            [(3, 0, 1)], heads=(q.shape[1], k_cache.shape[2]))
    route = _route(q)
    if route == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        kv_positions=kv_positions,
                                        q_pos=q_pos, window=window,
                                        scale=scale)
    _no_backward("decode_attention (K1)", q, k_cache, v_cache)
    with observed("decode_attention", lambda: _decode_cost(
            q, k_cache, v_cache, lengths, kv_positions, q_pos, window,
            scale)):
        if route == "meta":
            return _meta(q.shape[:2] + v_cache.shape[-1:], q.dtype)
        return _decode.decode_attention(
            q, k_cache, v_cache, lengths, kv_positions=kv_positions,
            q_pos=q_pos, window=window, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    if is_dtensor(q):
        from repro_torch.models.sharding import run_local
        return run_local(
            lambda q, k, v: flash_attention(
                q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
                kv_positions=kv_positions, window=window, scale=scale),
            (q, k, v), [(0, 2)] * 3, [(4, 0, 2)],
            heads=(q.shape[2], k.shape[2]))
    route = _route(q)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              kv_positions=kv_positions, window=window, scale=scale)
    if route == "cpu":
        return ref.flash_attention_ref(q, k, v, **kw)
    mla = _flash.is_mla(k, v, scale)
    grad = False
    if window == 0 and kv_positions is None and not mla:
        grad = _wants_grad(q, k, v)
    else:
        _no_backward(f"flash_attention (K2) in "
                     f"{'MLA' if mla else 'window'} mode", q, k, v)
    with observed("flash_attention", lambda: _flash_cost(
            q, k, v, causal, q_offset, kv_len, kv_positions, window, scale,
            lse=grad)):
        if grad:
            return _flash.FlashAttentionFn.apply(q, k, v, causal, q_offset,
                                                 kv_len, scale)
        if route == "meta":
            return meta_flash_attention(q, v)
        return _flash.flash_attention(q, k, v, **kw)


def topk_retrieval(queries: torch.Tensor, corpus: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    route = _route(queries)
    if route == "cpu":
        return ref.topk_retrieval_ref(queries, corpus, k)
    _no_backward("topk_retrieval (K3)", queries, corpus)
    with observed("topk_retrieval", lambda: (
            [(_topk.flops(queries, corpus), torch.float32)],
            _topk.bytes_moved(queries, corpus, k))):
        if route == "meta":
            return (_meta((queries.shape[0], k), torch.float32),
                    _meta((queries.shape[0], k), torch.int32))
        return _topk.topk_retrieval(queries, corpus, k)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor,
              dA: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if is_dtensor(x):
        from repro_torch.models.sharding import run_local
        return run_local(ssd_chunk, (x, dt, B, C, dA), [(0, 3)] * 5,
                         [(5, 0, 3), (5, 0, 2)], heads=(x.shape[3],))
    route = _route(x)
    if route == "cpu":
        return ref.ssd_chunk_ref(x, dt, B, C, dA)
    with observed("ssd_chunk", lambda: (
            _ssd.flops(x, B), _ssd.bytes_moved(x, dt, B, C, dA))):
        if _wants_grad(x, dt, B, C, dA):
            return _ssd.SsdChunkFn.apply(x, dt, B, C, dA)
        if route == "meta":
            return meta_ssd_chunk(x, B)
        return _ssd.ssd_chunk(x, dt, B, C, dA)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, sx: torch.Tensor,
                sw: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    route = _route(x)
    if route == "cpu":
        return ref.int8_matmul_ref(x, w, sx, sw, out_dtype)
    _no_backward("int8_matmul (K4)", x, w, sx, sw)
    with observed("int8_matmul", lambda: (
            [(_int8.ops(x, w), torch.int8)],
            _int8.bytes_moved(x, w, out_dtype))):
        if route == "meta":
            return _meta((x.shape[0], w.shape[1]), out_dtype)
        return _int8.int8_matmul(x, w, sx, sw, out_dtype)


def adamw(params: List[torch.Tensor], grads: List[torch.Tensor],
          m: List[torch.Tensor], v: List[torch.Tensor], lr: torch.Tensor,
          bc1: torch.Tensor, bc2: torch.Tensor, **hyper) -> torch.Tensor:
    """AdamW's step of every leaf (``kernels/adamw.py``), in place -> the
    gradients' global norm, one ``adamw`` operation to an observer.  The
    card and meta only: the kernel refuses CPU tensors, whose update is
    ``optimizer.plain_update``.  ``DTensor`` leaves (the dry-run's meshes)
    run on meta only: each gradient is first redistributed to its
    parameter's placements (the data-parallel reduction of a ``Partial``
    gradient), the call is counted on this rank's shards, and the norm's
    all-reduce follows it (:func:`_norm_all_reduce`).  The card refuses
    them, since its norm would be this rank's alone."""
    sharded = is_dtensor(params[0])

    def local(ts):
        return [t.to_local() if is_dtensor(t) else t for t in ts]

    def cost():
        leaves = [local(ts) for ts in (params, grads, m, v)]
        return ([(_adamw.flops(leaves[0]), torch.float32)],
                _adamw.bytes_moved(*leaves))

    meta = _route(local(params[:1])[0]) == "meta"
    if sharded and not meta:
        raise ValueError("adamw: DTensor leaves run only on meta; on the "
                         "card the kernel's norm would be this rank's")
    if sharded:
        grads = [g if g.placements == p.placements
                 else g.redistribute(p.device_mesh, p.placements)
                 for p, g in zip(params, grads)]
    # the kernel walks a leaf flat, so a gradient that autograd hands in
    # another layout than its parameter's (wo's (h, e, d) comes as a
    # transposed view) is copied to it first, as AccumulateGrad does
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    with observed("adamw", cost):
        if not meta:
            return _adamw.adamw(params, grads, m, v, lr, bc1, bc2, **hyper)
        gnorm = _meta((), torch.float32)
    return _norm_all_reduce(grads) if sharded else gnorm


def _norm_all_reduce(grads) -> torch.Tensor:
    """On a mesh the kernel's sum of squares is this rank's: the global
    norm sums it over the mesh dims each gradient is sharded on.  One 0-d
    f32 partial a group of gradients sharded alike, all-reduced by
    DTensor over its group's dims (the collectives an observer records),
    -> the norm (meta)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = grads[0].device_mesh
    total = _meta((), torch.float32)
    for dims in dict.fromkeys(tuple(p.is_shard() for p in g.placements)
                              for g in grads):
        if any(dims):
            part = DTensor.from_local(
                _meta((), torch.float32), mesh,
                [Partial() if d else Replicate() for d in dims],
                run_check=False)
            total = total + part.full_tensor()
    return torch.sqrt(total)


def launch_counts() -> Dict[str, int]:
    return {k.name: k.module.launches.count for k in KERNELS}


def mla_launch_counts() -> Dict[str, int]:
    """Launches of K1's and K2's MLA mode (a share of their counts)."""
    return {k.name: k.module.mla_launches.count for k in KERNELS
            if hasattr(k.module, "mla_launches")}


def backward_launch_counts() -> Dict[str, int]:
    return {k.name: k.module.launches.count for k in BACKWARD_KERNELS}


def optimizer_launch_counts() -> Dict[str, int]:
    """Calls of each optimizer kernel (an AdamW call launches the
    ``adamw_sumsq`` + ``adamw_step`` pair once per ``adamw.MAX_LEAVES``
    leaves; ``adamw.leaves`` holds the last call's leaves)."""
    return {k.name: k.module.launches.count for k in OPTIMIZER_KERNELS}


def reset_launch_counts() -> None:
    for k in (*OPTIMIZER_KERNELS, *BACKWARD_KERNELS):
        k.module.launches.reset()
    for k in KERNELS:
        k.module.launches.reset()
        if hasattr(k.module, "mla_launches"):
            k.module.mla_launches.reset()
