"""K1's and K2's MLA mode in bf16 (``decode_mla_wgmma``,
``flash_mla_wgmma``) measured on the card at ``chip_smoke.check_mla``'s
shapes: deepseek-v2's absorbed form, 128 heads over the 576-wide latent
rows of a cache, values their first 512 columns, scale 1/sqrt(192).

* Each shape with the plan's split count, held to the plain version and
  to the near-exact one as ``check_mla`` holds it, and timed as
  ``chip_smoke.timed`` times the kernels (calls queued back to back).
* K1 at 64, 333 and 923 keys with every split count the cluster takes
  (1 to 8): where ``flash_attention.MLA_SPLIT_TILES`` comes from.
* ``--src DIR`` takes ``repro_torch`` from DIR (the ``src`` of another
  checkout, such as the parent commit's, unpacked beside this one) and
  runs the shapes with its own plan, so that two versions compare in one
  call: run them in turns (old, new, new, old), one process each.

Needs one GPU:

    python3 mla_sweep.py [--src DIR] [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# check_mla's bf16 cases: (name, K1 or K2, arguments of the bench's case)
DECODE = [("decode_attention MLA 128 heads S=64", dict(S=64, slots=1024)),
          ("decode_attention MLA 128 heads S=333", dict(S=333, slots=1024)),
          ("decode_attention MLA 128 heads S=923", dict(S=923, slots=1024)),
          ("decode_attention MLA S=923 no split",
           dict(S=923, slots=1024, nsplit=1)),
          ("decode_attention MLA ragged [300,77,0]",
           dict(b=3, S=300, lengths=[300, 77, 0]))]
FLASH = [(f"flash_attention MLA absorbed sq={sq} q_offset={off}", sq, off)
         for sq, off in ((128, 0), (128, 384), (128, 772), (77, 256),
                         (5, 0))]


def close(got, want, tol):
    """|got - want| <= atol + rtol·|want| (tol: atol = rtol, or a pair)."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all()), \
        f"max|err| {err:.3e} over {tol}"
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory repro_torch is imported from")
    ap.add_argument("--json", default=None,
                    help="write the times (us) here as one JSON object")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.launch import kernels_bench as kb
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[sweep] {card}; repro_torch from {args.src}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    floor = kb.timed(lambda: torch.cuda._sleep(0))[0]
    print(f"[sweep] launch floor (an empty kernel): {1e3 * floor:.2f} us",
          flush=True)

    def kernel_us(fn, calls=20):
        """Device time a call of the MLA kernels alone, from a profile."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()
                   if "_mla" in e.key) / calls

    def run(name, c):
        got = c["kernel"]()
        err = close(got, c["plain"](), c["tol"])
        xerr = close(got, c["exact"](), c["exact_tol"])
        dev, host = kb.timed(c["kernel"])
        us = 1e3 * dev
        print(f"[sweep] {name}: {us:.2f} us (host-paced {1e3 * host:.2f}, "
              f"in the kernels {kernel_us(c['kernel']):.2f}; max|err| "
              f"{err:.2e} plain, {xerr:.2e} near-exact)", flush=True)
        return us

    out = {"card": card, "src": args.src, "floor_us": 1e3 * floor,
           "shapes": {}, "splits": {}}
    for name, kw in DECODE:
        kw = dict(kw)
        b = kw.pop("b", 1)
        c = kb.mla_decode_case(b, 128, kw.pop("S"), bf, g, **kw)
        out["shapes"][name] = run(name, c)
    for name, sq, off in FLASH:
        c = kb.mla_flash_case(1, sq, 128, off + sq, 1, 576, 512, bf, g,
                              q_offset=off)
        out["shapes"][name] = run(name, c)
    if hasattr(k2, "mla_wgmma_plan"):
        for S in (64, 333, 923):
            tiles = -(-S // k2.MLA_KEYS)
            planned = k2.mla_wgmma_plan(1, 1, 128, 1, S)[1]
            row = {}
            for n in range(1, min(tiles, k2.MLA_MAX_SPLIT) + 1):
                chunk, got = k2.mla_wgmma_plan(1, 1, 128, 1, S, n)
                if got != n:
                    continue    # n splits of whole tiles do not exist here
                c = kb.mla_decode_case(1, 128, S, bf, g, nsplit=n,
                                       slots=1024)
                row[n] = run(f"decode S={S} nsplit={n}", c)
            print(f"[sweep] decode S={S} by splits, us (plan {planned}): "
                  + ", ".join(f"{n}: {us:.2f}" for n, us in row.items()),
                  flush=True)
            out["splits"][S] = row
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
