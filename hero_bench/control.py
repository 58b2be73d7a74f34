"""Readings that set the limits of a train cell's comparison, on the chip
at the cell's own size: for each seed the program's numbers (after a
short window) and, with ``--control``, the control's (the reference with
its products in fp8, the next precision below the configuration's bf16,
in the program's place) and the half-batch fault's.  The benchmark's
own runs do not run this.

    python3 hero_bench/control.py --workload qwen3-1.7b-train-4x4096 \\
        --seeds 11,12,13 --control 11,12,13 --seconds 3
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def train_seed(wl, conf, seed, seconds, dev, control: bool) -> dict:
    from hero_bench import check, train
    run = train.run(wl, conf, seed, seconds, False, dev, time.monotonic())
    weights, batches, opt = run.weights, run.check_batches, run.opt
    sample = run.readings["sample"]
    t0 = time.monotonic()
    out = {"seed": seed, "program": check.check_train(run, wl)}
    out["reference_s"] = time.monotonic() - t0
    del run
    check._free_device()
    if control:
        out.update(check.control_train(conf, weights, batches, opt, sample))
    return out


def main(argv=None) -> int:
    import torch
    from hero_bench import registry
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="",
                    help="seeds (of --seeds) that also read the control")
    ap.add_argument("--seconds", type=float, default=3)
    args = ap.parse_args(argv)
    wl = registry.load_workload(args.workload)
    conf = registry.load_config(wl["config"])
    dev = torch.device("cuda")
    ctl = {int(x) for x in args.control.split(",") if x}
    for s in (int(x) for x in args.seeds.split(",")):
        print(json.dumps(train_seed(wl, conf, s, args.seconds, dev,
                                    s in ctl)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
