"""The port's BiLSTM op (plain version, CPU) against the JAX package's
merged-bidirectional Pallas kernel run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.ops import bilstm
from tests.jax_interpret import at_test_fold

T = 16


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    at_test_fold(monkeypatch)
    pallas_lstm.FORCE_INTERPRET = True
    prev = pallas_lstm.RESIDUAL_DTYPE
    pallas_lstm.RESIDUAL_DTYPE = jnp.float32
    yield
    pallas_lstm.FORCE_INTERPRET = False
    pallas_lstm.RESIDUAL_DTYPE = prev


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("h", [1, 8, 32])
def test_bilstm_matches_pallas_interpret(b, h):
    rng = np.random.RandomState(100 * h + b)
    xp_f, xp_b = (rng.randn(T, b, 4 * h).astype(np.float32) for _ in "fb")
    # JAX w_hh is [H, 4H]; the port takes torch's [4H, H]
    w_f, w_b = ((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
                for _ in "fb")
    want = pallas_lstm.bilstm_sequence(
        jnp.asarray(xp_f), jnp.asarray(xp_b), jnp.asarray(w_f),
        jnp.asarray(w_b),
    )
    got = bilstm.bilstm_sequence(
        torch.from_numpy(xp_f), torch.from_numpy(xp_b),
        torch.from_numpy(w_f.T.copy()), torch.from_numpy(w_b.T.copy()),
    )
    assert not any(bilstm.LAUNCHES.values())
    for g, w in zip(got, want):
        assert g.shape == (T, b, h)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_backward_direction_runs_in_reverse():
    """h_b at the last time index sees only xp_b[T-1]."""
    rng = np.random.RandomState(7)
    xp = torch.from_numpy(rng.randn(T, 2, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
    _, h_b = bilstm.bilstm_sequence(xp, xp, w, w)
    _, h_last = bilstm.bilstm_sequence(xp[-1:].contiguous(),
                                       xp[-1:].contiguous(), w, w)
    torch.testing.assert_close(h_b[-1], h_last[0])


def test_wrapper_rejects_bad_shapes():
    xp = torch.zeros(4, 2, 32)
    with pytest.raises(ValueError, match=r"\[4H, H\]"):
        bilstm._check(xp, xp, torch.zeros(8, 32), torch.zeros(8, 32))
    with pytest.raises(ValueError, match="H <="):
        big = torch.zeros(2, 1, 4 * 1024)
        w = torch.zeros(4 * 1024, 1024)
        bilstm._check(big, big, w, w)
