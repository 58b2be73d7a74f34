"""Dry-run of the port: every (architecture x input shape) cell on one H100
and on the production meshes, on the meta device — port of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell with XLA on 256 or 512 fake
devices and reads the compiled program's cost.  Eager PyTorch has no such
program, so the port runs it: parameters, optimizer state, inputs and
caches are meta tensors (shapes and types, no data), each kernel call of
``kernels/ops.py`` gives empty outputs of its result shapes, and
``launch/op_cost.py`` counts what one device runs.  On a production mesh
the parameters, inputs and caches are ``DTensor``s placed by the sharding
plan (``models/sharding.py``) over a fake process group of 256 or 512
ranks, this process rank 0, so the counts are rank 0's program.  A
sharding the plan cannot carry, a shape error or an operation with no
rule fails the cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --multi-pod 1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
        --out results/dryrun.jsonl

``--multi-pod``: ``1`` (one H100, no process group), ``single`` (16x16),
``multi`` (2x16x16), ``both`` (all three).  Each record has the
reference's keys, so ``benchmarks/roofline.py`` renders the file; its
roofline terms are datasheet arithmetic over the counts (989 TFLOP/s
bf16, 3.35 TB/s of HBM, 450 GB/s of NVLink a direction: an H100 SXM at
700 W), not measurements.  Needs no GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Iterable, Optional

import torch
from torch import nn

from repro_torch.configs import (SHAPES_BY_NAME, get_config, list_archs,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import h100
from repro_torch.launch.mesh import (destroy, make_fake_mesh,
                                     make_production_mesh)
from repro_torch.launch.op_cost import OpCounter
from repro_torch.models import build_model, input_specs, make_step_fn
from repro_torch.models import sharding
from repro_torch.training.optimizer import AdamWConfig, AdamWState
from repro_torch.training.train_loop import TrainConfig, make_train_step

PEAK_FLOPS = h100.PEAK_FLOPS[torch.bfloat16]
# name -> (shape, axes); "1" is one H100 with no process group, "2x2" a
# small fake mesh for checks
MESHES = {"1": ((), ()), "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MESH_CHOICES = {"1": ("1",), "single": ("16x16",), "multi": ("2x16x16",),
                "both": ("1", "16x16", "2x16x16")}


def _train_cfg(cfg: ModelConfig, grad_accum: int = 1) -> TrainConfig:
    big = cfg.param_count() > 50e9
    return TrainConfig(optimizer=AdamWConfig(
        state_dtype="bfloat16" if big else "float32"),
        grad_accum=grad_accum)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor; a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def local_bytes(tensors: Iterable[Any]) -> int:
    """Bytes of this rank's shards of ``tensors`` (host ints skipped)."""
    return sum(_local(t).numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _distribute_module(params: nn.Module, mesh) -> Dict[str, tuple]:
    """Replaces each parameter by a DTensor placed by the sharding plan;
    -> {name: placements}."""
    from torch.distributed.tensor import distribute_tensor
    placed = sharding.param_shardings(params, mesh)
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        dt = nn.Parameter(distribute_tensor(p.detach(), mesh, placed[name]),
                          requires_grad=p.requires_grad)
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = dt
        else:
            setattr(mod, leaf, dt)
    return placed


def _distribute(tree, placed, mesh):
    """A tree of tensors (dicts) with its placements tree -> DTensors."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: (_distribute(v, placed[k], mesh) if k in placed else v)
                for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placed)


def _cell(cfg: ModelConfig, shape: ShapeConfig, mesh, grad_accum: int):
    """Builds one cell on meta (distributed over ``mesh`` if given) ->
    (step thunk, argument tensors)."""
    specs = input_specs(cfg, shape)
    if mesh is not None:
        placed = sharding.input_shardings(cfg, shape, mesh, specs)
        specs = {k: _distribute(v, placed[k], mesh) for k, v in specs.items()}
    if shape.kind == "train":
        init, step = make_train_step(cfg, _train_cfg(cfg, grad_accum),
                                     device="meta")
        params, opt = init(0)
        if mesh is not None:
            placed = _distribute_module(params, mesh)
            opt = AdamWState(opt.step, *(
                {k: _distribute(v, placed[k], mesh) for k, v in m.items()}
                for m in (opt.m, opt.v)))
        args = [*params.parameters(), *_leaves((opt.m, opt.v)),
                *_leaves(specs)]
        return (lambda: step(params, opt, specs["batch"])), args
    params = build_model(cfg, "meta").init(0)
    if mesh is not None:
        _distribute_module(params, mesh)
    fn = make_step_fn(cfg, shape)
    args = [*params.parameters(), *_leaves(specs)]
    if shape.kind == "prefill":
        return (lambda: fn(params, specs["batch"])), args
    return (lambda: fn(params, specs["tokens"], specs["cache"])), args


def _make_mesh(name: str):
    if name == "1":
        return None
    if name in ("16x16", "2x16x16"):
        return make_production_mesh(multi_pod=name == "2x16x16")
    return make_fake_mesh(*MESHES[name])


def devices(name: str) -> int:
    return math.prod(MESHES[name][0])


def count_cell(arch: str, shape_name: str, *, mesh: str = "1",
               overrides: Optional[Dict] = None):
    """Runs one cell under an :class:`OpCounter`; -> ((counter, argument
    bytes, output bytes, seconds), the config), or (None, the reason)
    where ``shape_applicable`` skips the cell."""
    overrides = dict(overrides or {})
    grad_accum = int(overrides.pop("grad_accum", 1))
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, why
    dev_mesh = _make_mesh(mesh)
    sharding.set_activation_mesh(dev_mesh)
    try:
        t0 = time.perf_counter()
        step, args = _cell(cfg, shape, dev_mesh, grad_accum)
        arg_bytes = local_bytes(args)
        ctx = contextlib.nullcontext()
        if dev_mesh is not None:        # host-made scalars are replicated
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            ctx = implicit_replication()
        with ctx, OpCounter() as counter:
            out = step()
        out_bytes = local_bytes(_leaves(out[:2] if shape.kind == "train"
                                        else out))
        return (counter, arg_bytes, out_bytes,
                time.perf_counter() - t0), cfg
    finally:
        sharding.set_activation_mesh(None)


def count_train_step(cfg: ModelConfig, batch: int, seq: int, device,
                     tcfg: Optional[TrainConfig] = None, seed: int = 0):
    """One train step of ``cfg`` (``make_train_step``: loss, gradients,
    AdamW) on ``batch`` x ``seq`` tokens on ``device`` — random weights
    and tokens on the card or the CPU, their shapes on meta — run under an
    :class:`OpCounter`; -> (the counter, a thunk that runs the same step
    again).  The card's count equals meta's: the same operations, and each
    kernel call counted by its wrapper's formulas."""
    dev = torch.device(device)
    init, step = make_train_step(cfg, tcfg or TrainConfig(), device=dev)
    params, opt = init(seed)
    if dev.type == "meta":
        toks = torch.empty((batch, seq), dtype=torch.int64, device=dev)
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        toks = torch.randint(4, cfg.vocab_size, (batch, seq), generator=g,
                             device=dev)
    data = {"tokens": toks, "labels": toks}
    with OpCounter() as counter:
        step(params, opt, data)
    return counter, lambda: step(params, opt, data)


def roofline(cost: Dict[str, Any], coll: Dict[str, float], chips: int,
             cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The reference's three roofline terms (seconds) at the H100's
    datasheet rates; every count is per device."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(sum(coll.values()))
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / h100.HBM_BYTES_PER_S
    t_coll = coll_dev / h100.NVLINK_BYTES_PER_S
    n = (cfg.active_param_count() if cfg.moe.enabled else cfg.param_count())
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n * toks
    global_flops = flops_dev * chips
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "model_flops": model_flops,
        "hlo_flops_global": global_flops,
        "useful_flops_frac": (model_flops / global_flops
                              if global_flops else 0.0),
        "bottleneck": max(
            [("compute", t_compute), ("memory", t_memory),
             ("collective", t_coll)], key=lambda kv: kv[1])[0],
    }


def error_site(e: BaseException) -> str:
    """Where a cell failed: the innermost frame of the port outside the
    counter (``repro_torch/...py:line``), then the operation the counter
    saw fail and, in a backward, its autograd node, as
    ``repro_torch/models/moe.py:120 aten.view.default`` or
    ``... aten._unsafe_view.default in UnsafeViewBackward0``."""
    site = "?"
    for f in traceback.extract_tb(e.__traceback__):
        path = f.filename.replace(os.sep, "/")
        if "/repro_torch/" in path and not path.endswith("/op_cost.py"):
            site = f"{path[path.rindex('/repro_torch/') + 1:]}:{f.lineno}"
    op = getattr(e, "aten_op", None)
    if op is not None:
        site += f" {op}"
        node = getattr(e, "autograd_node", None)
        if node is not None:
            site += f" in {node}"
    return site


def run_cell(arch: str, shape_name: str, *, mesh: str = "1",
             verbose: bool = True,
             overrides: Optional[Dict] = None) -> Dict[str, Any]:
    """One cell -> its record (``status`` ok, skipped or error)."""
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh}
    try:
        got, cfg = count_cell(arch, shape_name, mesh=mesh,
                              overrides=overrides)
        if got is None:
            rec.update(status="skipped", reason=cfg)
            return rec
        counter, arg_bytes, out_bytes, secs = got
        shape = SHAPES_BY_NAME[shape_name]
        cost = {"flops": counter.flops, "bytes accessed": counter.bytes}
        coll = dict(counter.collectives)
        peak = counter.peak_bytes + arg_bytes
        rec.update(
            status="ok", run_s=round(secs, 1),
            memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                    "temp_bytes": counter.peak_bytes, "peak_bytes": peak},
            kernels=dict(counter.kernels),
            kernel_flops=counter.kernel_flops,
            collectives=coll,
            roofline=roofline(cost, coll, devices(mesh), cfg, shape),
            fits_16gb_hbm=bool(peak < 16e9),
            fits_80gb_hbm=bool(peak < h100.HBM_BYTES))
    except Exception as e:  # a failing cell is a fault of the port
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   where=error_site(e))
    if verbose:
        print(json.dumps(rec)[:400], flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="single",
                    choices=list(MESH_CHOICES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SHAPES_BY_NAME) if (args.all or args.shape is None)
              else [args.shape])
    cells = [(a, s, m) for m in MESH_CHOICES[args.multi_pod]
             for a in archs for s in shapes]
    done = set()
    if args.resume and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            done = {(r["arch"], r["shape"], r["mesh"])
                    for r in map(json.loads, f)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n = {"ok": 0, "skipped": 0, "error": 0}
    try:
        with open(args.out, "a") if args.out else \
                contextlib.nullcontext() as out_f:
            for cell in cells:
                if cell in done:
                    continue
                rec = run_cell(*cell[:2], mesh=cell[2])
                n[rec["status"]] += 1
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
    finally:
        destroy()
    print(f"dry-run complete: ok={n['ok']} skipped={n['skipped']} "
          f"errors={n['error']}")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
