"""Training loop — port of ``repro/training/train_loop.py``:
``make_train_step`` (loss -> gradients, with remat per the model config
-> AdamW) and the single-host ``train`` driver with checkpoints.

Gradient accumulation runs the ``grad_accum`` microbatches of ``B /
grad_accum`` rows one after the other, summing their gradients in f32,
then divides by ``grad_accum`` (the loss is averaged; the per-microbatch
metrics are dropped, as the reference's scan does).  The parameters and
moments are updated in place (``optimizer.adamw_update``).  A loss or
norm is read to the host only at a log step, so a step never waits for
the device otherwise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import (SPAN_BACKWARD, SPAN_FORWARD,
                                    SPAN_TRAIN_STEP, span)
from repro_torch.models import build_model
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)

Batch = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_accum: int = 1
    # the reference's field for an int8-compressed pod all-reduce; its
    # train step reads neither (training/grad_compression.py has the
    # all-reduce)
    compress_pod_grads: bool = False
    pod_axis: str = "pod"


def value_and_grad(model_loss, params: nn.Module, batch: Batch
                   ) -> Tuple[Tuple[torch.Tensor, Dict[str, Any]],
                              Dict[str, torch.Tensor]]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: -> ((loss, metrics),
    {name: gradient}); a parameter the loss does not reach gets zeros, as
    in JAX.  The loss runs in a ``train.forward`` span and the gradients
    in a ``train.backward`` span (``core/spans.py``)."""
    with span(SPAN_FORWARD):
        loss, metrics = model_loss(params, batch)
    named = list(params.named_parameters())
    with span(SPAN_BACKWARD):
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True,
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), {
        k: g for (k, _), g in zip(named, grads)}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig(),
                    device: DeviceLike = None):
    """-> (init, train_step): ``init(seed)`` gives trainable parameters and
    a fresh optimizer state on ``device``; ``train_step(params, state,
    batch)`` -> (params, state, metrics) with ``loss``, ``grad_norm`` and
    ``lr`` (and ``ce``/``aux``/``mtp_ce`` without accumulation), inside a
    ``train.step`` span."""
    model = build_model(cfg, device)

    def train_step(params: nn.Module, opt_state: AdamWState, batch: Batch
                   ) -> Tuple[nn.Module, AdamWState, Dict[str, Any]]:
        with span(SPAN_TRAIN_STEP):
            accum = tcfg.grad_accum
            if accum > 1:
                grads: Dict[str, torch.Tensor] = {}
                loss = 0.0
                rows = next(iter(batch.values())).shape[0] // accum
                for i in range(accum):
                    mb = {k: x[i * rows:(i + 1) * rows]
                          for k, x in batch.items()}
                    (lm, _), g = value_and_grad(model.loss_fn, params, mb)
                    for k, gk in g.items():
                        grads[k] = grads[k] + gk.float() if k in grads \
                            else gk.float()
                    loss = loss + lm
                grads = {k: g / accum for k, g in grads.items()}
                loss = loss / accum
                metrics: Dict[str, Any] = {}
            else:
                (loss, metrics), grads = value_and_grad(model.loss_fn,
                                                        params, batch)
            params, opt_state, opt_metrics = adamw_update(
                grads, opt_state, params, tcfg.optimizer)
            return params, opt_state, {**metrics, **opt_metrics,
                                       "loss": loss}

    def init(seed: int) -> Tuple[nn.Module, AdamWState]:
        params = model.init(seed, trainable=True)
        return params, adamw_init(params, tcfg.optimizer)

    return init, train_step


def train(cfg: ModelConfig, data_iter: Iterator[Batch], *, steps: int,
          tcfg: TrainConfig = TrainConfig(), seed: int = 0,
          checkpointer=None, checkpoint_every: int = 0, log_every: int = 10,
          restore: bool = False, device: DeviceLike = None
          ) -> Tuple[nn.Module, AdamWState, List[Dict[str, float]]]:
    """Single-host driver: from ``seed`` (or, with ``restore``, from the
    checkpointer's latest step) to ``steps``, a checkpoint every
    ``checkpoint_every`` steps; -> (params, state, history) with
    ``{"step", "loss", "grad_norm", "wall"}`` at each log step."""
    dev = resolve_device(device)
    init, step_fn = make_train_step(cfg, tcfg, dev)
    params, opt_state = init(seed)
    start = 0
    if restore and checkpointer is not None:
        restored = checkpointer.restore_latest((params, opt_state))
        if restored is not None:
            (params, opt_state), start = restored
    history = []
    t0 = time.time()
    for step in range(start, steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            history.append({"step": step,
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "wall": time.time() - t0})
        if checkpointer is not None and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            checkpointer.save((params, opt_state), step + 1)
    if checkpointer is not None:
        checkpointer.wait()
    return params, opt_state, history
