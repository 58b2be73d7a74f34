"""Sharding plan: parameters / inputs / caches -> DTensor placements —
port of ``repro/models/sharding.py``.

The reference's scheme (GSPMD FSDP + TP, MaxText-style), rule for rule:

- 2D weights shard (in=data, out=model) for "up" products and (in=model,
  out=data) for "down" products: fully sharded parameters.
- MoE experts shard E on ``model`` (expert parallelism) and d on ``data``.
- The ``pod`` axis is pure data parallelism: parameters replicated across
  pods, the batch sharded over (pod, data).
- A dim that does not divide its mesh axis stays unsharded.
- Decode KV caches shard the sequence dim over ``model``; batch 1
  (long_500k) shards it over (data, model) (sequence parallelism).

Each rule gives a spec as the reference's ``PartitionSpec`` does, one
entry per tensor dim (None, an axis name, or a tuple of them);
:func:`placements` turns it into DTensor placements, one per mesh dim:
``Shard(d)`` on each mesh axis named for dim d, else ``Replicate()``.
Where the reference relies on GSPMD to lay out an operation, the port
runs on ``DTensor``: its sharding propagation, and :func:`run_local`
(``local_map`` with declared placements) for the kernels, which work per
(batch row, head) on local shards.

``constrain(x, names)`` pins an activation's layout (the reference's
``with_sharding_constraint``) while an activation mesh is set
(:func:`set_activation_mesh`: the dry-run), and is the identity
otherwise.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.ops import is_dtensor

Spec = Tuple[Any, ...]      # per tensor dim: None, an axis, or a tuple


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: Mapping[str, int], name: str) -> int:
    return sizes.get(name, 1)


def _div(n: int, sizes: Mapping[str, int], axis: str) -> Optional[str]:
    return axis if n % max(_axis_size(sizes, axis), 1) == 0 else None


def batch_axes(sizes: Mapping[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in sizes)


def _batch_spec_dim(sizes: Mapping[str, int], b: int):
    axes = batch_axes(sizes)
    total = math.prod(_axis_size(sizes, a) for a in axes)
    if axes and b % total == 0:
        return axes
    # fall back to data-only, then replicated
    if "data" in sizes and b % _axis_size(sizes, "data") == 0:
        return ("data",)
    return None


def placements(spec: Spec, mesh) -> tuple:
    """A spec -> DTensor placements over ``mesh``'s dims."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


# ---------------------------------------------------------------------------
# activation sharding constraints
# ---------------------------------------------------------------------------

_ACTIVATION_MESH = None


def set_activation_mesh(mesh) -> None:
    global _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh


def activation_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                    sizes: Mapping[str, int]) -> Spec:
    """names per dim: "batch" (pod + data), "data", "model", or None;
    dims that do not divide their axis stay unsharded."""
    spec = []
    for dim, name in zip(shape, names):
        if name is None:
            spec.append(None)
        elif name == "batch":
            axes = batch_axes(sizes)
            total = math.prod(_axis_size(sizes, a) for a in axes)
            spec.append(axes if (axes and dim % total == 0) else None)
        else:
            spec.append(name if dim % _axis_size(sizes, name) == 0
                        else None)
    return tuple(spec)


def embed(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``; on a DTensor table sharded on its
    vocab dim (over ``model``), each rank looks up the ids in its shard (0
    elsewhere) and the result is a partial sum over those mesh dims; a
    table sharded on its width is gathered whole first.  The ids keep
    their batch layout."""
    import torch.nn.functional as F
    if not is_dtensor(table):
        return F.embedding(ids, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    tab_pl = [pl if pl.is_shard(0) else Replicate() for pl in table.placements]
    table = table.redistribute(mesh, tab_pl)
    split = [i for i, pl in enumerate(tab_pl) if pl.is_shard(0)]
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ids_pl = [Replicate() if i in split else pl
              for i, pl in enumerate(ids.placements)]
    ids = ids.redistribute(mesh, ids_pl)
    offset = _shard_offset(mesh, split, table.shape[0])

    def lookup(tl, il):
        local = il - offset
        inside = (local >= 0) & (local < tl.shape[0])
        got = F.embedding(local.clamp(0, tl.shape[0] - 1), tl)
        return torch.where(inside[..., None], got, torch.zeros_like(got))
    out_pl = [Partial() if i in split else
              (Shard(0) if pl.is_shard(0) else Replicate())
              for i, pl in enumerate(ids_pl)]
    return local_map(lookup, out_placements=out_pl,
                     in_placements=(tab_pl, ids_pl), device_mesh=mesh)(
        table, ids)


def _shard_offset(mesh, dims, size: int) -> int:
    """This rank's first index of a dim of ``size`` split over mesh dims
    ``dims`` (torch.chunk's split, as ``Shard`` places it)."""
    offset = 0
    for i in dims:
        size = -(-size // mesh.size(i))
        offset += mesh.get_local_rank(i) * size
    return offset


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.gather(-1, idx)``; on a DTensor whose last dim is sharded (the
    vocab of the logits over ``model``), each rank gathers the indices
    that fall in its shard (0 elsewhere) and the result is a partial sum
    over those mesh dims, reduced where it is next used."""
    if not is_dtensor(x):
        return x.gather(-1, idx)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, last = x.device_mesh, x.ndim - 1
    split = [i for i, pl in enumerate(x.placements) if pl.is_shard(last)]
    if not split:
        return x.gather(-1, idx)
    idx_pl = [Replicate() if i in split else pl
              for i, pl in enumerate(x.placements)]
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    idx = idx.redistribute(mesh, idx_pl)
    offset = _shard_offset(mesh, split, x.shape[last])

    def gather(xl, il):
        local = il - offset
        inside = (local >= 0) & (local < xl.shape[-1])
        got = xl.gather(-1, local.clamp(0, xl.shape[-1] - 1))
        return torch.where(inside, got, torch.zeros_like(got))
    out_pl = [Partial() if i in split else pl
              for i, pl in enumerate(x.placements)]
    return local_map(gather, out_placements=out_pl,
                     in_placements=(list(x.placements), idx_pl),
                     device_mesh=mesh)(x, idx)


class _LayoutOfGrad(torch.autograd.Function):
    """The identity; its backward redistributes the gradient to the
    value's own layout."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout)


def grad_in_layout(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient a DTensor program takes in ``x``'s layout
    (before a view of it, say, that a layout DTensor picked for the
    gradient could not pass); the identity on a plain tensor."""
    return _LayoutOfGrad.apply(x) if is_dtensor(x) else x


def divides(n: int, axis: str) -> bool:
    """Whether ``n`` splits evenly over mesh axis ``axis`` of the
    activation mesh (always, with none set)."""
    mesh = _ACTIVATION_MESH
    return mesh is None or n % _axis_size(axis_sizes(mesh), axis) == 0


def constrain(x: torch.Tensor,
              names: Tuple[Optional[str], ...]) -> torch.Tensor:
    """Redistributes a DTensor ``x`` to the layout ``names`` give while an
    activation mesh is set; the identity otherwise."""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return x
    spec = activation_spec(x.shape, names, axis_sizes(mesh))
    return x.redistribute(mesh, placements(spec, mesh))


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

def _param_rule(name: str, shape: Tuple[int, ...], sizes: Mapping[str, int],
                is_expert: bool = False) -> Tuple[Spec, int]:
    """The reference's rule for a leaf -> (spec of its trailing dims, the
    rule's rank)."""
    D, M = "data", "model"

    def div(n, axis):
        return _div(n, sizes, axis)

    if name in ("scale", "bias", "dt_bias", "gate_bias", "A_log", "D",
                "xgate"):
        return (), 0
    if name == "embed":
        return (div(shape[-2], M), div(shape[-1], D)), 2
    if name == "lm_head":
        return (div(shape[-2], D), div(shape[-1], M)), 2
    if name in ("wq", "wk", "wv") and len(shape) >= 3:   # attn (d, h, e)
        return (div(shape[-3], D), div(shape[-2], M), None), 3
    if name in ("wq", "wk", "wv"):                       # mLSTM (d, di)
        return (div(shape[-2], D), div(shape[-1], M)), 2
    if name == "wo":              # attention out-proj (h, e, d)
        return (div(shape[-3], M), None, div(shape[-1], D)), 3
    if name == "w_out":           # ssm/xlstm down-proj (di, d)
        return (div(shape[-2], M), div(shape[-1], D)), 2
    if name in ("bq", "bk", "bv"):
        return (div(shape[-2], M), None), 2
    # routed experts by PATH (under 'moe', not 'shared'): a dense MLP of
    # the same rank would otherwise lose its ff sharding
    if name in ("w_up", "w_gate") and is_expert:        # experts (E, d, ff)
        return (div(shape[-3], M), div(shape[-2], D), None), 3
    if name == "w_down" and is_expert:                  # experts (E, ff, d)
        return (div(shape[-3], M), None, div(shape[-1], D)), 3
    if name in ("w_up", "w_gate"):
        return (div(shape[-2], D), div(shape[-1], M)), 2
    if name == "w_down":
        return (div(shape[-2], M), div(shape[-1], D)), 2
    if name == "router":
        return (), 0
    if name in ("wq_a", "wkv_a"):
        return (div(shape[-2], D), None), 2
    if name in ("wq_b", "wk_b", "wv_b"):
        return (None, div(shape[-2], M), None), 3
    if name in ("wz", "wx", "W", "R", "proj"):
        return (div(shape[-2], D), div(shape[-1], M)), 2
    if name in ("wB", "wC", "wgate", "wdt"):
        return (div(shape[-2], D), div(shape[-1], M)), 2
    if name in ("conv", "conv_x", "conv_B", "conv_C"):
        return (None, div(shape[-1], M)), 2
    return (), 0


# the port's flat leaf names -> the reference's (bridge.MLA_NORMS, SHARED)
_FLAT_NORMS = ("q_norm", "kv_norm")
_SHARED = "shared_"


def leaf_rule_args(path: str) -> Tuple[str, bool]:
    """A parameter's dotted name -> (the reference's leaf name, whether it
    is a routed expert's: under ``moe`` and not a shared expert)."""
    keys = path.split(".")
    leaf = keys[-1]
    is_expert = "moe" in keys and not leaf.startswith(_SHARED)
    if leaf in _FLAT_NORMS:
        leaf = "scale"
    elif leaf.startswith(_SHARED):
        leaf = leaf[len(_SHARED):]
    return leaf, is_expert


def param_spec(path: str, shape: Tuple[int, ...],
               sizes: Mapping[str, int]) -> Spec:
    """One parameter's spec: its rule on the trailing dims, leading dims
    unsharded; a rule wider than the leaf leaves it replicated."""
    name, is_expert = leaf_rule_args(path)
    spec, _ = _param_rule(name, shape, sizes, is_expert)
    pad = len(shape) - len(spec)
    if pad < 0:
        return (None,) * len(shape)
    return (None,) * pad + tuple(spec)


def param_shardings(params: nn.Module, mesh) -> Dict[str, tuple]:
    """{parameter name: placements} of a model's parameters."""
    sizes = axis_sizes(mesh)
    return {name: placements(param_spec(name, tuple(p.shape), sizes), mesh)
            for name, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# input / cache shardings
# ---------------------------------------------------------------------------

def _cache_rule(name: str, shape: Tuple[int, ...],
                sizes: Mapping[str, int], batch: int) -> Spec:
    """Caches carry a leading stacked-layer dim: (L, B, S, ...).  The
    sequence dim shards over ``model``; batch 1 (long_500k) shards it over
    ``data`` too (sequence parallelism).  The port's ``latent`` (L, B, S,
    kv_lora + rope) is the reference's ``ckv`` and ``krope`` side by
    side, under their rule."""
    bspec = _batch_spec_dim(sizes, batch)
    seq_shard = bspec is None
    M, D = "model", "data"

    def seq_spec(s):
        axes = ([D] if seq_shard else []) + [M]
        total = math.prod(_axis_size(sizes, a) for a in axes)
        return tuple(axes) if s % max(total, 1) == 0 else None

    def div(n, axis):
        return _div(n, sizes, axis)

    if name in ("k", "v"):        # (L, B, S, n, e)
        return (None, bspec, seq_spec(shape[-3]), None, None)
    if name in ("ckv", "krope", "latent"):          # (L, B, S, r)
        return (None, bspec, seq_spec(shape[-2]), None)
    if name == "pos":             # (L, W) ring positions
        return (None,) * len(shape)
    if name == "ssm":             # (L, B, H, P, N)
        return (None, bspec, div(shape[-3], M), None, None)
    if name in ("conv_x", "conv_B", "conv_C", "conv"):  # (L, B, K-1, c)
        return (None, bspec, None, div(shape[-1], M))
    if name == "C":               # mlstm (L, B, H, P, P)
        return (None, bspec, div(shape[-3], M), None, None)
    if name == "n":               # (L, B, H, P)
        return (None, bspec, div(shape[-2], M), None)
    if name == "m":               # (L, B, H)
        return (None, bspec, div(shape[-1], M))
    if name in ("c", "h"):        # slstm (L, B, d)
        return (None, bspec, None)
    return (None,) * len(shape)


def cache_spec(name: str, shape: Tuple[int, ...], sizes: Mapping[str, int],
               batch: int) -> Spec:
    """:func:`_cache_rule`, cut or padded to the leaf's rank (slstm's
    ``n``/``m`` against mlstm's, as the reference does)."""
    spec = _cache_rule(name, shape, sizes, batch)
    if len(spec) > len(shape):
        return tuple(spec[:len(shape)])
    return tuple(spec) + (None,) * (len(shape) - len(spec))


def cache_shardings(cache: Mapping[str, Any], cfg: ModelConfig, mesh,
                    batch: int) -> Dict[str, Any]:
    """The cache's tree with each tensor leaf's placements (``idx``, a
    host int, is left out)."""
    sizes = axis_sizes(mesh)
    out: Dict[str, Any] = {}
    for k, v in cache.items():
        if isinstance(v, Mapping):
            out[k] = {n: placements(cache_spec(n, tuple(t.shape), sizes,
                                               batch), mesh)
                      for n, t in v.items()}
        elif isinstance(v, torch.Tensor):
            out[k] = placements(cache_spec(k, tuple(v.shape), sizes, batch),
                                mesh)
    return out


def batch_spec(shape: Tuple[int, ...], sizes: Mapping[str, int]) -> Spec:
    return (_batch_spec_dim(sizes, shape[0]),) + (None,) * (len(shape) - 1)


def batch_shardings(batch: Mapping[str, torch.Tensor],
                    mesh) -> Dict[str, tuple]:
    sizes = axis_sizes(mesh)
    return {k: placements(batch_spec(tuple(t.shape), sizes), mesh)
            for k, t in batch.items()}


def input_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    specs: Mapping[str, Any]) -> Dict[str, Any]:
    """Placements matching ``models.input_specs(cfg, shape)``."""
    out: Dict[str, Any] = {}
    if "batch" in specs:
        out["batch"] = batch_shardings(specs["batch"], mesh)
    if "tokens" in specs:
        out["tokens"] = batch_shardings({"t": specs["tokens"]}, mesh)["t"]
    if "cache" in specs:
        out["cache"] = cache_shardings(specs["cache"], cfg, mesh,
                                       shape.global_batch)
    return out


# ---------------------------------------------------------------------------
# kernels on local shards
# ---------------------------------------------------------------------------

def run_local(fn: Callable[..., Any], operands: Sequence[Any],
              layouts: Sequence[Optional[Tuple[int, Optional[int]]]],
              out_layouts: Sequence[Tuple[int, int, Optional[int]]],
              heads: Sequence[int]):
    """``fn`` on this rank's shards of DTensor ``operands``: each tensor
    operand is redistributed to its ``layouts`` entry, (batch dim or
    None, head dim or None), or passed as it is where that is None; each
    output is
    declared at its ``out_layouts`` entry, (rank, batch dim, head dim or
    None).  The batch dim shards over (pod, data) where it divides, the
    head dim over ``model`` only where every count in ``heads`` divides
    it (so each shard keeps whole GQA groups), every other dim stays
    whole.  -> DTensor output(s)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in operands if isinstance(a, DTensor)).device_mesh
    sizes = axis_sizes(mesh)
    heads_ok = all(h % _axis_size(sizes, "model") == 0 for h in heads)
    batch = next(a for a, lay in zip(operands, layouts)
                 if lay is not None).shape[layouts[0][0]]
    bspec = activation_spec((batch,), ("batch",), sizes)[0]

    def place(ndim, batch_dim, head_dim):
        spec: list = [None] * ndim
        if batch_dim is not None:
            spec[batch_dim] = bspec
        if head_dim is not None and heads_ok:
            spec[head_dim] = "model"
        return placements(tuple(spec), mesh)

    in_pl, args = [], []
    for a, lay in zip(operands, layouts):
        if lay is None:
            in_pl.append(None)
            args.append(a)
            continue
        if not isinstance(a, DTensor):      # a host-made index, replicated
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = place(a.ndim, *lay)
        in_pl.append(list(pl))
        args.append(a.redistribute(mesh, pl))
    # local_map reads a tuple as one entry per output, a list as one
    # output's placements
    out_pl = [list(place(*lay)) for lay in out_layouts]
    return local_map(fn, out_placements=tuple(out_pl) if len(out_pl) > 1
                     else out_pl[0], in_placements=tuple(in_pl),
                     device_mesh=mesh)(*args)
