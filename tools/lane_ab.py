#!/usr/bin/env python3
"""Device time of the multi-stream lane kernels at bfloat16 compute, in
this checkout or, in turns, in this one and another.

    python3 tools/lane_ab.py [--against DIR] [--rounds N]

Alone it times, on the GPU of this machine, in the checkout it is run
from (the working directory), the bfloat16-W instances of the lane
kernels at (8, 32, 1) with W_hh mixed as the models give it (float32 at
H=1): the residual-saving forward and the gradient at B16 at either
residual dtype, and the lean forward at B28, each by
``chip_smoke.kernel_device_ms`` over 20 calls, and prints one line
``LANE {...}`` of ms. With ``--against DIR`` it prints the card's name
and power limit, runs itself in DIR and here in turns (DIR, here, here,
DIR, N rounds), each a process of its own that builds that checkout's
kernels, and prints each run's line and the medians. Exits non-zero
where there is no card.
"""

import argparse
import json
import os
import subprocess
import sys


def measure() -> dict:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from speechsplit_tpu_torch.ops import multi_bilstm as m

    if not torch.cuda.is_available():
        c.fail("no CUDA device")
    out = {}
    hs, n, d2 = (8, 32, 1), 3, 6
    for rd in (torch.bfloat16, torch.float32):
        xps, ws = c.compute_multi_inputs(c.T, 16, hs, 5)
        got = m.multi_bilstm_forward_cuda(n, *xps, *ws, residual_dtype=rd)
        dhs = [torch.randn(x.shape, device="cuda") for x in got[:d2]]
        res = got[d2:]
        tag = "bf16" if rd == torch.bfloat16 else "f32"
        out[f"fwd_{tag}"] = c.kernel_device_ms(
            lambda: m.multi_bilstm_forward_cuda(n, *xps, *ws,
                                                residual_dtype=rd), 20)
        out[f"bwd_{tag}"] = c.kernel_device_ms(
            lambda: m.multi_bilstm_backward_cuda(n, *dhs, *res, *ws), 20)
    xps, ws = c.compute_multi_inputs(c.T, 28, hs, 6)
    out["infer"] = c.kernel_device_ms(
        lambda: m.multi_bilstm_infer_cuda(n, *xps, *ws), 20)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", metavar="DIR")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    if args.against is None:
        print("LANE " + json.dumps(measure()), flush=True)
        return 0
    import numpy as np

    here = os.getcwd()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    trees = {"other": os.path.abspath(args.against), "this": here}
    runs = {label: [] for label in trees}
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__)],
                                  cwd=trees[label], capture_output=True,
                                  text=True, timeout=600)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("LANE ")]
            if proc.returncode or not lines:
                print(proc.stdout[-2000:], proc.stderr[-2000:],
                      file=sys.stderr)
                return 1
            runs[label].append(json.loads(lines[-1][5:]))
            print(label, lines[-1], flush=True)
    for key in runs["this"][0]:
        other, this = (np.median([r[key] for r in runs[label]])
                       for label in ("other", "this"))
        print(f"median {key} other={other:.4f} this={this:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
