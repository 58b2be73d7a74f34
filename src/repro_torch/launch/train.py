"""Training launcher of the port — port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen1.5-0.5b --reduced --steps 20 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 50 --batch 8 --seq 256 --ckpt-dir build/ckpt

Trains one model on synthetic data (one process, one device): on CUDA
unless ``--device cpu``; ``--reduced`` trains the smoke-scale f32 config.
Async checkpoints every ``--ckpt-every`` steps; ``--resume`` restarts
from the newest complete one.  On the card, attention runs K2 and its
backward kernel and the Mamba2 layers K5 and its backward kernel; the
family whose path has a kernel mode with no backward (moe: K2's MLA
mode) raises there and trains on the CPU.
"""
from __future__ import annotations

import argparse
from typing import Dict, Iterator, Optional, Sequence

import torch

from repro_torch import DeviceLike, resolve_device, torch_dtype
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.training import TrainConfig, train
from repro_torch.training.optimizer import AdamWConfig


def synthetic_data(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                   device: DeviceLike = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of uniform tokens in [4, vocab) (labels = tokens), with the
    vlm's patch embeddings or the audio model's frames where the config
    has them; batch ``i`` is drawn from a generator seeded ``seed + i``
    on ``device``."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    step = 0
    while True:
        g = torch.Generator(device=dev).manual_seed(seed + step)
        toks = torch.randint(4, cfg.vocab_size, (batch, seq), generator=g,
                             device=dev)
        out = {"tokens": toks, "labels": toks}
        if cfg.vlm.enabled:
            out["vision_embeds"] = torch.randn(
                (batch, cfg.vlm.vision_tokens, cfg.vlm.vision_dim),
                generator=g, device=dev).to(dt)
        if cfg.encdec.enabled:
            out["audio_frames"] = torch.randn(
                (batch, cfg.encdec.source_positions, cfg.d_model),
                generator=g, device=dev).to(dt)
        yield out
        step += 1


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr,
                                             total_steps=args.steps),
                       grad_accum=args.grad_accum)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    params, _, hist = train(cfg, synthetic_data(cfg, args.batch, args.seq,
                                                device=dev),
                            steps=args.steps, tcfg=tcfg, checkpointer=ck,
                            checkpoint_every=args.ckpt_every,
                            restore=args.resume, device=dev)
    for h in hist:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  wall {h['wall']:.1f}s")
    return hist


if __name__ == "__main__":
    main()
