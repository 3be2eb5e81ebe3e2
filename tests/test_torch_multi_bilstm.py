"""The port's multi-stream BiLSTM op (plain version, CPU) against the JAX
package's multi-stream Pallas kernel run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_lstm, pallas_multilstm
from speechsplit_tpu_torch.ops import _build, multi_bilstm
from tests.jax_interpret import at_test_fold
from tests.test_pallas_multilstm import STREAMS

T = 16

# (T, B, widths) on the CUDA kernel's plans: each width alone (the lane
# plan's L = 1, 2, 8, 16 and 32, with units past H at 5, 9 and 31; the
# block plan's 33 and 64), mixed widths up to 8 directions,
# ragged batches (1, 3, 33: lane groups holding rows past the batch) and
# T = 1. The JAX op takes every one of these shapes.
PLAN_CASES = [(7, 3, (h,)) for h in (1, 2, 5, 8, 9, 16, 31, 32, 33, 64)] + [
    (9, 33, (1, 2, 5, 8)), (5, 1, (9, 16, 31, 32)), (6, 3, (33, 64, 8, 1)),
    (1, 33, (32, 8, 1))]


def plan_case_id(case):
    t, b, hs = case
    return f"T{t}-B{b}-H{'_'.join(map(str, hs))}"


def plan_inputs(t, b, hs):
    """Seeded xp [t, b, 4h] and JAX-layout w [h, 4h], two a width."""
    rng = np.random.RandomState(t * 1000 + b * 10 + len(hs))
    xs = [rng.randn(t, b, 4 * h).astype(np.float32)
          for h in hs for _ in (0, 1)]
    ws = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
          for h in hs for _ in (0, 1)]
    return xs, ws


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    at_test_fold(monkeypatch)
    pallas_lstm.FORCE_INTERPRET = True
    prev = pallas_lstm.RESIDUAL_DTYPE
    pallas_lstm.RESIDUAL_DTYPE = jnp.float32
    yield
    pallas_lstm.FORCE_INTERPRET = False
    pallas_lstm.RESIDUAL_DTYPE = prev


@pytest.mark.parametrize(
    "streams", [STREAMS, STREAMS[1:]], ids=["generator", "f0_converter"]
)
@pytest.mark.parametrize("b", [1, 8])
def test_multi_bilstm_matches_pallas_interpret(streams, b):
    rng = np.random.RandomState(len(streams) * 10 + b)
    xs, ws = [], []
    for four_h, h in streams:
        for _ in range(2):
            xs.append(rng.randn(T, b, four_h).astype(np.float32))
            ws.append((rng.randn(h, four_h) / np.sqrt(h)).astype(np.float32))
    n = len(streams)
    want = pallas_multilstm.multi_bilstm_sequence(
        n, None, *map(jnp.asarray, xs), *map(jnp.asarray, ws)
    )
    got = multi_bilstm.multi_bilstm_sequence(
        n, *map(torch.from_numpy, xs),
        *(torch.from_numpy(w.T.copy()) for w in ws),
    )
    assert not any(multi_bilstm.LAUNCHES.values())
    assert len(got) == len(want) == 2 * n
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_wrapper_rejects_bad_arguments():
    xp = torch.zeros(4, 2, 32)
    w = torch.zeros(32, 8)
    with pytest.raises(ValueError, match="expected 4"):
        multi_bilstm.multi_bilstm_sequence(1, xp, xp, w)
    with pytest.raises(ValueError, match="shared T and B"):
        multi_bilstm._check(1, (xp, torch.zeros(4, 3, 32)), (w, w))
    with pytest.raises(ValueError, match="H <="):
        wide = torch.zeros(4, 2, 4 * 128)
        multi_bilstm._check(1, (wide, wide), (torch.zeros(512, 128),) * 2)


@pytest.mark.parametrize("case", PLAN_CASES, ids=plan_case_id)
def test_plain_lean_matches_infer_on_the_kernel_plans(case):
    t, b, hs = case
    xs, ws = plan_inputs(t, b, hs)
    n = len(hs)
    want = pallas_multilstm._infer(n, *map(jnp.asarray, xs + ws))
    got = multi_bilstm.multi_bilstm_sequence(
        n, *map(torch.from_numpy, xs),
        *(torch.from_numpy(w.T.copy()) for w in ws))
    assert not any(multi_bilstm.LAUNCHES.values())
    assert len(got) == len(want) == 2 * n
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_wrapper_limits_are_the_kernel_sources():
    # the wrapper reads its limits from the forwards' source; the gradient
    # kernel, which takes the same tensors, must state the same
    assert (multi_bilstm.MAX_DIRECTIONS, multi_bilstm.MAX_HIDDEN) == (8, 64)
    assert _build.source_constant("multi_bilstm_bwd", "kMaxDirs") == (
        multi_bilstm.MAX_DIRECTIONS)
    assert _build.source_constant("multi_bilstm_bwd", "kMaxH") == (
        multi_bilstm.MAX_HIDDEN)
