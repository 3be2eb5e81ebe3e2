"""The port's multi-stream BiLSTM op (plain version, CPU) against the JAX
package's multi-stream Pallas kernel run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_lstm, pallas_multilstm
from speechsplit_tpu_torch.ops import multi_bilstm
from tests.test_pallas_multilstm import STREAMS

T = 16


@pytest.fixture(autouse=True)
def interpret_mode():
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
