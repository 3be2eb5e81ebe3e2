"""JAX's Pallas kernels in interpret mode for the port's tests, at a
short fold.

``TEST_FOLD`` is how many timesteps a grid step of JAX's merged and
multi-stream kernels unrolls in these tests (their own fold is 4 or 16):
a grid step computes the same cells in the same order at any fold, and in
interpret mode the compile time grows with it (JAX's bfloat16 generator
step at tiny widths: 66 s at the kernels' own folds, 33 s at 2, on one
CPU core)."""

from speechsplit_tpu.ops import pallas_lstm, pallas_multilstm

TEST_FOLD = 2


def at_test_fold(monkeypatch):
    """JAX's merged and multi-stream kernels at ``TEST_FOLD``."""
    monkeypatch.setattr(pallas_lstm, "_max_fold", lambda h: TEST_FOLD)
    monkeypatch.setattr(pallas_multilstm, "_MAX_FOLD", TEST_FOLD)


def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, at ``TEST_FOLD``."""
    monkeypatch.setattr(pallas_lstm, "FORCE_INTERPRET", True)
    at_test_fold(monkeypatch)
