"""The layer-level VJP (``ops.bilstm.bilstm_layer``, routed by
``ops.bilstm.LAYER_VJP``) against JAX's (``pallas_lstm.bilstm_layer``,
``LAYER_VJP``, pallas_lstm.py:990-1103): a 2-layer ``LSTM`` with the
switch on in both packages, its output and parameter gradients against
JAX's layer, at float32 and at bfloat16 residuals. JAX's kernels run in
interpret mode, its layer op by op.

Bars: at float32 residuals every contraction is float32, 2e-5 of each
gradient's largest magnitude (the layers' bar, PARITY.md); at bfloat16
residuals those of tests/test_torch_stream_switches.py (2^-8 plus one
bfloat16 ulp). There the layer VJP forms dW_ih and dx from operands
rounded to bfloat16 and the composed path does not, so the two routes'
gradients differ; the port's differ (by more than 1e-4 of the largest
magnitude) in exactly the parameters where JAX's do.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.ops import bilstm
from tests.jax_interpret import interpret
from tests.test_torch_compute_bf16 import assert_dw_close
from tests.test_torch_residual_bf16 import H_TOL, _f32
from tests.test_torch_stream_switches import layer_grads, lstm_pair

LAYER_TOL = 2e-5
APART = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _vjp(monkeypatch, mode: str) -> None:
    monkeypatch.setattr(pallas_lstm, "LAYER_VJP", mode)
    monkeypatch.setattr(bilstm, "LAYER_VJP", mode)


def _run(monkeypatch, rd: str, mode: str, seed: int = 41):
    _vjp(monkeypatch, mode)
    rng = np.random.RandomState(seed)
    x, mod, params, ours = lstm_pair(rng, "float32", rd)
    routed = []
    real = bilstm.BiLSTMLayerFunction.apply
    monkeypatch.setattr(bilstm.BiLSTMLayerFunction, "apply",
                        lambda *a: routed.append(1) or real(*a))
    out = layer_grads(rng, x, mod, params, ours)
    assert len(routed) == (2 if mode == "on" else 0)  # a layer each
    return out


def test_layer_vjp_float32_residuals_match_jax(monkeypatch):
    want_out, want, out, got = _run(monkeypatch, "float32", "on")
    np.testing.assert_allclose(_f32(out), _f32(want_out), atol=H_TOL)
    for key, value in want.items():
        g, w = _f32(got[key]), _f32(value)
        assert float(np.abs(g - w).max()) <= LAYER_TOL * float(
            np.abs(w).max()), key
    assert not any(bilstm.LAUNCHES.values())


def test_layer_vjp_bfloat16_residuals_match_jax_and_part_where_jax_does(
        monkeypatch):
    _, want_on, out, got_on = _run(monkeypatch, "bfloat16", "on")
    for key, value in want_on.items():
        assert_dw_close(got_on[key], value, key)
    _, want_off, _, got_off = _run(monkeypatch, "bfloat16", "off")

    def apart(a, b):
        a, b = _f32(a), _f32(b)
        return float(np.abs(a - b).max()) > APART * float(np.abs(b).max())

    parted = {k: apart(want_on[k], want_off[k]) for k in want_on}
    assert any(parted.values()) and not all(parted.values())
    assert {k: apart(got_on[k], got_off[k]) for k in got_on} == parted
    assert jnp.dtype(want_on["w_ih_l0"].dtype) == jnp.float32
