"""Run one cell of the benchmark and print its result as the last line
of standard output.

    python3 hero_bench/run.py --workload qwen3-1.7b-train-4x4096 \\
        --seed 1234 --seconds 20 --trace 0

From the repository root; the program is imported from ``src``.  Exits
non-zero, printing no result, without enough CUDA devices, or if JAX or
the JAX package was loaded by the time the window closed."""
from __future__ import annotations

import time

T_PROC0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("USE_TF", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> None:
    print(f"hero_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from hero_bench import registry
    from hero_bench.report import measure
    wl = registry.load_workload(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if torch.cuda.device_count() < wl["chips"]:
        fail(f"{wl['chips']} CUDA devices needed, "
             f"{torch.cuda.device_count()} visible")
    result, checks = measure(wl, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda"), T_PROC0)
    bad = forbidden_modules()
    if bad:
        fail(f"loaded in the measuring process: {', '.join(bad)}")
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
