#!/usr/bin/env python3
"""Build and run ``tools/step_probe.cu`` on the GPU of this machine.

    python3 tools/step_probe.py

Compiles the probe with nvcc for sm_90a into a temporary directory,
prints the card's name and power limit, then the probe's PROBE lines.
Exits non-zero where there is no nvcc or no card.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from speechsplit_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "step_probe")
        subprocess.run([_build._nvcc(), *flags, "-o", exe,
                        str(ROOT / "tools" / "step_probe.cu")], check=True)
        return subprocess.run([exe], timeout=600).returncode


if __name__ == "__main__":
    sys.exit(main())
