#!/usr/bin/env python3
"""Where the float32 generator train step's host time goes, on the GPU of
this machine.

    python3 tools/adam_probe.py

Builds the kernels, prints the card's name and power limit, then the
cost of one ``training.train_step.matmul_precision`` context (the TF32
switch each step makes) and, in turns over 20 timed rounds after 4, the
float32 generator step (``chip_smoke.float32_config``, B16xT192) with
the port's ``Adam`` and with torch's foreach ``torch.optim.Adam``, each
with the precision context and with it replaced by a no-op: the median
and quartiles of a step, and of one ``optimizer.step()`` alone, both by
the host clock ending in a synchronize. Exits non-zero where there is
no card.
"""

import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from speechsplit_tpu_torch.config import SpeechSplitConfig  # noqa: E402
from speechsplit_tpu_torch.training import (  # noqa: E402
    create_train_state,
    make_train_step,
)
from speechsplit_tpu_torch.training import train_step  # noqa: E402

ROUNDS, WARMUP = 24, 4


@contextlib.contextmanager
def no_switch(name):
    yield


def context_ms(n: int = 200) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        with train_step.matmul_precision("highest"):
            pass
    return (time.perf_counter() - start) * 1e3 / n


def main() -> int:
    if not torch.cuda.is_available():
        print("adam_probe: no CUDA device", file=sys.stderr)
        return 1
    print(c.card_line(), flush=True)
    c.phase_build()
    config = c.float32_config()
    batch = c.synthetic_batch(SpeechSplitConfig(), c.SEED)
    real = train_step.matmul_precision
    print(f"matmul_precision context ms {context_ms():.4f}", flush=True)
    states = {}
    for name in ("port", "port_no_switch", "torch", "torch_no_switch"):
        state = create_train_state(config, c.SEED, "speechsplit")
        if name.startswith("torch"):
            state.optimizer = torch.optim.Adam(
                state.model.parameters(), lr=config.learning_rate,
                betas=(config.adam_b1, config.adam_b2), eps=train_step.ADAM_EPS)
        states[name] = state
    step = make_train_step(config)
    step_ms = {k: [] for k in states}
    opt_ms = {k: [] for k in states}
    with c.strict_float32("timing"):
        for r in range(ROUNDS):
            for name in list(states) if r % 2 == 0 else list(states)[::-1]:
                train_step.matmul_precision = (
                    no_switch if name.endswith("no_switch") else real)
                torch.cuda.synchronize()
                start = time.perf_counter()
                step(states[name], batch)
                torch.cuda.synchronize()
                mid = time.perf_counter()
                states[name].optimizer.step()
                torch.cuda.synchronize()
                if r >= WARMUP:
                    step_ms[name].append((mid - start) * 1e3)
                    opt_ms[name].append((time.perf_counter() - mid) * 1e3)
    train_step.matmul_precision = real
    for name in states:
        q1, med, q3 = np.percentile(step_ms[name], [25, 50, 75])
        print(f"{name} step median {med:.4f} q1 {q1:.4f} q3 {q3:.4f} "
              f"optimizer.step median {np.median(opt_ms[name]):.4f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
