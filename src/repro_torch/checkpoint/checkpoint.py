"""Asynchronous checkpointing with restart-from-latest — port of
``repro/checkpoint/checkpoint.py``.

A tree is flattened to its tensor leaves and written as one
``step_XXXXXXXX.npz`` per save: the leaves are copied to host memory at
once, and a daemon thread writes them (to a temp file, then renamed), so
training never waits on the disk; ``wait()`` joins the thread and raises
what it raised.  ``manifest.json`` records the latest *complete* step and
is the only source of :meth:`Checkpointer.latest_step`, so a write cut
short is never restored; the newest ``keep`` checkpoints are kept.

Leaf order, the one order saves and restores share: a tensor is one leaf;
an ``nn.Module`` its parameters in ``named_parameters`` order; a dict its
values in key order as inserted; a tuple or list (an ``AdamWState`` is
``(step, m, v)``) its items in order, each flattened the same way.  So
``(params, opt_state)`` is every parameter, then ``step``, then ``m`` and
``v`` in ``named_parameters`` order.

Where JAX's arrays are immutable, torch parameters are updated in place,
and on the CPU ``t.cpu()`` is ``t`` itself: the snapshot copies every
leaf, or a later step would change what the thread is writing.  numpy has
no bfloat16: a bf16 leaf is stored as its raw 16 bits (int16) with its
dtype's name beside it, and restored bit-exact.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

_DTYPES = "__dtypes__"


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of ``tree`` in the documented order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _rebuild(template: Any, it: Iterator[torch.Tensor]) -> Any:
    """``template``'s structure with its leaves taken from ``it`` (already
    on the template leaf's device and dtype); a module's parameters are
    overwritten in place."""
    if isinstance(template, torch.Tensor):
        return next(it)
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for _, p in template.named_parameters():
                p.copy_(next(it))
        return template
    if isinstance(template, dict):
        return {k: _rebuild(v, it) for k, v in template.items()}
    items = [_rebuild(v, it) for v in template]
    if hasattr(template, "_fields"):            # a NamedTuple
        return type(template)(*items)
    return type(template)(items)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no storage with ``t``."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str,
                like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for a "
                         f"template leaf of shape {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------
    def save(self, tree: Any, step: int, block: bool = False):
        """Asynchronous save: copies the leaves to host memory now, writes
        them on a background thread."""
        self.wait()
        host = [_to_numpy(x) for x in leaves(tree)]
        dtypes = np.array([str(x.dtype).removeprefix("torch.")
                           for x in leaves(tree)])

        def _write():
            try:
                tmp = tempfile.mkdtemp(dir=self.dir)
                np.savez(os.path.join(tmp, "shards.npz"), **{
                    _DTYPES: dtypes,
                    **{f"leaf{i}": a for i, a in enumerate(host)}})
                final = os.path.join(self.dir, f"step_{step:08d}")
                os.replace(os.path.join(tmp, "shards.npz"),
                           final + ".npz.tmp")
                os.replace(final + ".npz.tmp", final + ".npz")
                shutil.rmtree(tmp, ignore_errors=True)
                self._write_manifest(step)
                self._gc()
            except BaseException as e:   # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_manifest(self, step: int):
        tmp = os.path.join(self.dir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"latest_step": step}, f)
        os.replace(tmp, os.path.join(self.dir, "manifest.json"))

    def _gc(self):
        steps = self.available_steps()
        for s in steps[:-self.keep]:
            try:
                os.remove(os.path.join(self.dir, f"step_{s:08d}.npz"))
            except OSError:
                pass

    # -- restore -------------------------------------------------------------
    def available_steps(self) -> List[int]:
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("step_") and fn.endswith(".npz"):
                out.append(int(fn[5:-4]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        mf = os.path.join(self.dir, "manifest.json")
        if not os.path.exists(mf):
            return None
        with open(mf) as f:
            return json.load(f)["latest_step"]

    def restore(self, template: Any, step: int) -> Any:
        """Restore into the structure, dtypes and devices of ``template``
        (a module's parameters are overwritten in place)."""
        path = os.path.join(self.dir, f"step_{step:08d}.npz")
        with np.load(path) as data:
            like = leaves(template)
            dtypes = data[_DTYPES]
            if len(dtypes) != len(like):
                raise ValueError(f"{path} holds {len(dtypes)} leaves, the "
                                 f"template {len(like)}")
            restored = [_from_numpy(data[f"leaf{i}"], str(dtypes[i]), t)
                        for i, t in enumerate(like)]
        return _rebuild(template, iter(restored))

    def restore_latest(self, template: Any
                       ) -> Optional[Tuple[Any, int]]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(template, step), step
