#!/usr/bin/env python3
"""Split the pitch decoder's time on the GPU of this machine.

    python3 tools/viterbi_probe.py

Builds ``speechsplit_tpu_torch/csrc/viterbi.cu`` with ``-DVITERBI_PROBE``
into a temporary directory and prints the card's name and power limit,
then a ``[viterbi probe]`` line at each of B1 T257, B16 T501 and B28
T1876 (K = 12): cycles a step of the forward pass and of the backtrace,
the probe build's device time, and the latency floor of T - 1
irreducible steps (``chip_smoke.phase_viterbi_probe``). Exits non-zero
where there is no nvcc or no card.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("viterbi_probe: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    chip_smoke.phase_viterbi_probe()
    return 0


if __name__ == "__main__":
    sys.exit(main())
