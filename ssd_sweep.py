"""K5's launch choices measured on the card, at zamba2-1.2b's widths (64
heads, P = N = 64, one group of B and C) in bf16:

* ``ssd_decode`` against ``ssd_chunk_mma`` at Q = 1 to 32, where the plan's
  threshold ``ssd_chunk.DECODE_MAX_Q`` comes from;
* ``ssd_chunk_mma``'s slices of P at Q in {64, 128, 256} and 256 x 2 chunks;
* ``ssd_decode``'s slices of S's rows at Q = 1 and 4.

Every launch is checked against the plain version (2e-4) and timed as
``chip_smoke.timed`` times the kernels: calls queued back to back.  The
smoke checks the plan's own choices at every run; this script re-measures
the choices themselves, after a change to the kernels.  Needs one GPU:

    python3 ssd_sweep.py
"""
from __future__ import annotations

import subprocess
import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_sweep: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ssd_chunk as k5
    g = torch.Generator(device="cuda").manual_seed(0)

    def us(Q, nc=1, **force):
        c = cs.ssd_case(1, nc, Q, 64, 64, 64, torch.bfloat16, True, g,
                        **force)
        cs.check_case(c, f"ssd_chunk Q={Q} nc={nc} {force}")
        return f"{1e3 * cs.timed(c['kernel'])[0]:.1f}"

    cs.say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip())
    floor = cs.timed(lambda: torch.cuda._sleep(0))[0]
    cs.say(f"[sweep] launch floor (an empty kernel): {1e3 * floor:.2f} us")
    cs.say(f"[sweep] ssd_decode / ssd_chunk_mma, us (the plan takes "
           f"ssd_decode up to Q={k5.DECODE_MAX_Q}): " + ", ".join(
               f"Q={Q}: {us(Q, kernel='ssd_decode')} / "
               f"{us(Q, kernel='ssd_chunk_mma')}"
               for Q in (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32)))
    for Q, nc in ((64, 1), (128, 1), (256, 1), (256, 2)):
        planned = k5.plan(1, nc, Q, 64, 64, 64, torch.bfloat16).splits
        cs.say(f"[sweep] ssd_chunk_mma Q={Q} nc={nc} by slices of P, us "
               f"(plan {planned}): " + ", ".join(
                   f"{s}: {us(Q, nc, kernel='ssd_chunk_mma', splits=s)}"
                   for s in k5.mma_slices(Q, 64, 64)))
    for Q in (1, 4):
        planned = k5.plan(1, 1, Q, 64, 64, 64, torch.bfloat16).splits
        cs.say(f"[sweep] ssd_decode Q={Q} by slices of S's rows, us (plan "
               f"{planned}): " + ", ".join(
                   f"{s}: {us(Q, kernel='ssd_decode', splits=s)}"
                   for s in k5.DECODE_SPLITS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
