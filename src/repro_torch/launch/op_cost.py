"""Operation-level cost counter of the port's program, for the dry-run's
roofline — the counterpart of the JAX package's ``launch/hlo_cost.py``.
That one walks XLA's optimized HLO; eager PyTorch has no HLO, so this
counts the tensor operations one device runs, as they run:

- **FLOPs** follow ``hlo_cost``'s convention: a product is 2·M·N·K
  (``mm``, ``addmm`` and ``baddbmm`` plus their add, ``bmm``, and so
  ``einsum``'s products and ``linear``), a convolution 2·outputs·(its
  kernel's taps times input channels a group), and each elementwise
  math op (``hlo_cost._MATH_OPS``: add, multiply, exp, tanh, rsqrt,
  compare, select, convert, ...) its output's element count.
  Reductions count nothing, as ``hlo_cost`` counts a reduce's scalar
  body once.
- **Bytes** are each operation's operands plus its results: XLA's
  fusion-boundary convention taken op by op.  Eager PyTorch fuses
  nothing, so this exceeds the reference's count for the same program.
  Views and allocations move nothing.
- **A kernel call** of ``kernels/ops.py`` (K1-K5, and K2's and K5's
  backward kernels) counts as one operation with its wrapper's own
  ``flops`` and ``bytes_moved`` (``ops.observed``), on the card and on
  the meta device alike; the tensor operations inside the call (output
  allocation, a plain version on the CPU) are not counted again.  So a
  step counted on meta equals the same step counted on the card.
- **Collective bytes** are the result bytes of every ``c10d_functional``
  collective, under ``hlo_cost``'s five names.
- **Peak live bytes**: every storage the counted program allocates, from
  its first output until it is freed (a weakref finalizer on the
  storage), at its most.
- **DTensor**: an operation on a ``DTensor`` is not counted; the local
  operations and collectives it runs on this rank's shards are, and the
  global-shape operations DTensor runs under its fake mode to propagate
  shardings are not.  Everything is per device, as ``hlo_cost``'s counts
  of the partitioned program are.

    with OpCounter() as c:
        step(...)
    c.result()     # {"flops", "bytes", "collectives"}, as hlo_cost.analyze
"""
from __future__ import annotations

import collections
import weakref
from typing import Any, Callable, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import ops

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_gather_into_tensor_coalesced": "all-gather",
                   "all_reduce": "all-reduce",
                   "all_reduce_coalesced": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "reduce_scatter_tensor_coalesced": "reduce-scatter",
                   "all_to_all_single": "all-to-all"}
# hlo_cost._MATH_OPS in aten's names
_MATH_OPS = {"add", "mul", "sub", "div", "exp", "tanh", "rsqrt", "sqrt",
             "log", "maximum", "minimum", "clamp", "clamp_min",
             "clamp_max", "eq", "ne", "lt", "le", "gt", "ge", "where",
             "_to_copy", "neg", "pow", "expm1", "sigmoid", "cos", "sin",
             "reciprocal", "abs", "square", "softplus", "exp2", "log1p",
             "logical_and", "logical_or", "logical_not"}
# composite elementwise ops as XLA spells them: silu = x·logistic(x)
_MATH_COST = {"silu": 2, "gelu": 8, "softplus": 4}
# operations that move no data: views, aliases, allocations
_FREE_OPS = {"view", "_unsafe_view", "reshape", "permute", "transpose", "t",
             "expand", "squeeze", "unsqueeze", "slice", "select", "alias",
             "detach", "as_strided", "split", "split_with_sizes", "chunk",
             "unbind", "lift_fresh", "empty", "empty_like", "empty_strided",
             "new_empty", "new_empty_strided", "unfold", "diagonal",
             "view_as_real", "view_as_complex", "_reshape_alias",
             "wait_tensor", "_wrap_tensor_autograd", "sym_size",
             "sym_stride", "sym_numel", "is_same_size", "_local_scalar_dense",
             "set_", "resize_"}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flops(name: str, args, out) -> float:
    """hlo_cost's FLOPs of one aten operation."""
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        m, k = a.shape
        n = b.shape[1]
        return 2.0 * m * n * k + (m * n if name == "addmm" else 0)
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        bs, m, k = a.shape
        n = b.shape[2]
        return 2.0 * bs * m * n * k + (bs * m * n if name == "baddbmm"
                                        else 0)
    if name == "convolution":       # weight (out, in / groups, *kernel)
        return 2.0 * out.numel() * args[1][0].numel()
    outs = _tensors(out)
    if name in _MATH_COST:
        return float(_MATH_COST[name] * sum(t.numel() for t in outs))
    if name in _MATH_OPS or name.rstrip("_") in _MATH_OPS:
        return float(sum(t.numel() for t in outs))
    return 0.0


class OpCounter(TorchDispatchMode):
    """FLOPs, bytes, collective bytes, kernel calls and peak live bytes of
    the operations run while it is entered (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.kernels: Dict[str, int] = collections.Counter()
        self.kernel_flops = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._in_kernel = 0

    # -- kernel calls (ops.observed) ---------------------------------------
    def kernel_enter(self, name: str, work, nbytes: int) -> None:
        if self._in_kernel == 0:
            ops_count = float(sum(n for n, _ in work))
            self.kernels[name] += 1
            self.flops += ops_count
            self.bytes += nbytes
            self.kernel_flops += ops_count
        self._in_kernel += 1

    def kernel_exit(self) -> None:
        self._in_kernel -= 1

    def __enter__(self):
        ops.add_observer(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ops.remove_observer(self)

    # -- memory ------------------------------------------------------------
    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, args, out) -> None:
        """Each output storage that is neither an input's (an in-place op,
        a view) nor already live is a new allocation, live until freed."""
        seen = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key)

    # -- operations --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if DTensor in types:
            return NotImplemented       # count its local operations instead
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                  # DTensor's sharding propagation
        self._track((args, kwargs), out)
        if self._in_kernel:
            return out
        name = func.overloadpacket.__name__
        ns = func.namespace
        if "c10d" in ns:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                res = sum(_nbytes(t) for t in _tensors(out))
                self.collectives[kind] += res
                self.bytes += res + sum(_nbytes(t)
                                        for t in _tensors((args, kwargs)))
            return out
        if name in _FREE_OPS:
            return out
        self.flops += _flops(name, args, out)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        return out

    def result(self) -> Dict[str, Any]:
        """``hlo_cost.analyze``'s record."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives)}


def analyze(fn: Callable[..., Any], *args, **kwargs) -> Dict[str, Any]:
    """Runs ``fn(*args, **kwargs)`` under an :class:`OpCounter`; ->
    {"flops", "bytes", "collectives"}, as ``hlo_cost.analyze`` gives for
    a compiled program."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.result()
