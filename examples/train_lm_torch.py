"""Train a ~100M-parameter LM for a few hundred steps with checkpoint and
restart, on the PyTorch port (``repro_torch``).

The qwen1.5 topology scaled to ~100M parameters, synthetic data, the
port's AdamW with its cosine schedule, an async checkpoint every 50 steps,
then restart-from-latest for 20 more steps.  Runs on CUDA (attention on
K2 and its backward kernel) unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]
"""
import argparse
import dataclasses
import tempfile

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch.train import synthetic_data
from repro_torch.training import AdamWConfig, TrainConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    # ~100M params: qwen1.5 family topology, 12 x 512 width
    cfg = dataclasses.replace(
        get_config("qwen1.5-0.5b"), num_layers=12, d_model=512,
        num_heads=8, num_kv_heads=8, head_dim=64, d_ff=1408,
        vocab_size=32000, dtype="float32", remat="none")
    n = cfg.param_count()
    print(f"model: {n / 1e6:.1f}M params, {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq}")

    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=6e-4, warmup_steps=20, total_steps=args.steps))
    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir)
        params, _, hist = train(
            cfg, synthetic_data(cfg, args.batch, args.seq,
                                device=args.device),
            steps=args.steps, tcfg=tcfg, checkpointer=ck,
            checkpoint_every=50, log_every=20, device=args.device)
        for h in hist:
            print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
                  f"gnorm {h['grad_norm']:.3f}  {h['wall']:.0f}s")
        print(f"checkpoints: {ck.available_steps()}")
        print("restart-from-latest for 20 more steps...")
        _, _, hist2 = train(
            cfg, synthetic_data(cfg, args.batch, args.seq,
                                device=args.device),
            steps=args.steps + 20, tcfg=tcfg, checkpointer=ck,
            restore=True, log_every=10, device=args.device)
        print(f"  resumed at step {hist2[0]['step']}, "
              f"final loss {hist2[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
