#!/usr/bin/env python3
"""Count the ``torch.profiler`` windows that see no device time.

    python3 tools/profiler_windows.py [--windows N] [--plan wpw]

Runs ``--plan`` a letter at a time in one process: ``w`` opens
``chip_smoke.profiled_busy_us``'s window N times (10 calls of cuDNN's
training forward at T192 B16 H8 under ``strict_float32``, as
``phase_lstm_kernels`` times the smoke's H8 yardstick); ``p`` runs
``chip_smoke.phase_viterbi_probe`` as ``phase_viterbi`` does, which
loads the decoder's probe build into this process. Prints the card's
name and power limit, then one ``[profiler windows]`` line a ``w``: its
place in the plan, the windows, how many saw no device time, and the
device ms a call (min, median, max) of the others, and the arm's
seconds. Exits non-zero where there is no card.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def arm(place: str, fn, windows: int, reps: int) -> None:
    wall = time.perf_counter()
    busy = [chip_smoke.profiled_busy_us(fn, reps) for _ in range(windows)]
    wall = time.perf_counter() - wall
    seen = sorted(b / 1e3 / reps for b in busy if b > 0)
    chip_smoke.log(
        "profiler windows", plan=place, windows=windows,
        empty=windows - len(seen),
        device_ms_min=f"{seen[0]:.4f}" if seen else "none",
        device_ms_median=f"{statistics.median(seen):.4f}" if seen else "none",
        device_ms_max=f"{seen[-1]:.4f}" if seen else "none",
        seconds=f"{wall:.1f}")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--windows", type=int, default=300)
    parser.add_argument("--plan", default="wpw")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    xp, w, _ = chip_smoke.lstm_inputs(chip_smoke.T, chip_smoke.TRAIN_B, 8,
                                      chip_smoke.SEED + 19 * 8
                                      + chip_smoke.TRAIN_B)
    yard = chip_smoke.cudnn_lstm_yardstick(xp, w)
    x = xp.detach().clone().requires_grad_(True)
    with chip_smoke.strict_float32():
        for i, step in enumerate(args.plan):
            if step == "p":
                chip_smoke.phase_viterbi_probe(((1, 257), (28, 1876)), 20)
            else:
                place = f"{args.plan[:i]}[{step}]{args.plan[i + 1:]}"
                arm(place, lambda: yard(x), args.windows, 10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
