"""The residual dtype the port's recurrence ops and its ``LSTM`` layer
save in when a caller gives none equals the JAX package's: None stands
for ``RESIDUAL_DTYPE``, bfloat16 (pallas_lstm.py:79-83,
pallas_multilstm.py:404-407, layers.py:270).

Each op is called with no residual dtype in both packages (JAX's kernels
in interpret mode) on the same inputs and cotangents, at B4 T6 H8: the
gradients agree within 1e-5 of their largest magnitude. A float32
default, as the port had, misses by about 5e-3 there (both sides then
round different residuals). The layer (B8; float32 sums taken in
another order in each package, so a value may round to a neighbouring
bfloat16 one before dW_hh's product) is held to the dW bar of
tests/test_torch_compute_bf16.py, 2^-8 of each gradient's largest
magnitude plus one ulp of the element, and at most 2% of all its
gradients' elements past 1e-5 of their tensor's largest magnitude
(measured: none of 960 here, 23 of 4,992 with two layers, all in one
dW_hh; the float32 default puts 931 of the 960 past).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.models import layers as jl
from speechsplit_tpu.ops import pallas_lstm, pallas_multilstm
from speechsplit_tpu_torch.models import layers as tl
from speechsplit_tpu_torch.ops import bilstm, lstm, multi_bilstm
from tests.jax_interpret import interpret
from tests.test_torch_compute_bf16 import FLIP_SHARE, assert_dw_close
from tests.test_torch_residual_bf16 import _f32, _t

T, B, H, I = 6, 4, 8, 5
TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _rel_close(got, want, what: str) -> None:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, what
    err = float(np.abs(g - w).max())
    assert err <= TOL * float(np.abs(w).max()), (what, err)


def test_every_default_is_none_for_bfloat16():
    assert bilstm.RESIDUAL_DTYPE == torch.bfloat16
    assert pallas_lstm.RESIDUAL_DTYPE == jnp.bfloat16
    for fn in (bilstm.bilstm_sequence, bilstm.bilstm_sequence_fused,
               bilstm.bilstm_layer, lstm.lstm_sequence,
               multi_bilstm.multi_bilstm_sequence, tl.LSTM):
        assert inspect.signature(fn).parameters[
            "residual_dtype"].default is None, fn
    assert tl.LSTM(3, 2, 1, torch.Generator()).residual_dtype == (
        torch.bfloat16)


def _ops(rng):
    """{name: (port op, JAX op, JAX inputs, port inputs, transposed
    input positions)} for the four ops, none given a residual dtype."""
    def xp(four_h):
        return rng.randn(T, B, four_h).astype(np.float32)

    def w(h):
        return (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)

    merged = [xp(4 * H), xp(4 * H), w(H), w(H)]
    single = [xp(4 * H), w(H)]
    widths = (8, 1)
    multi = [xp(4 * h) for h in widths for _ in "fb"] + [
        w(h) for h in widths for _ in "fb"]
    x = rng.randn(T, B, I).astype(np.float32)
    fused = [x, (rng.randn(I, 4 * H) / 3).astype(np.float32),
             (rng.randn(I, 4 * H) / 3).astype(np.float32),
             rng.randn(4 * H).astype(np.float32),
             rng.randn(4 * H).astype(np.float32), w(H), w(H)]
    n = len(widths)
    return {
        "merged": (bilstm.bilstm_sequence, pallas_lstm.bilstm_sequence,
                   merged, (2, 3)),
        "single": (lambda a, b: (lstm.lstm_sequence(a, b),),
                   lambda a, b: (pallas_lstm.lstm_sequence(a, b),),
                   single, (1,)),
        "multi": (lambda *a: multi_bilstm.multi_bilstm_sequence(n, *a),
                  lambda *a: pallas_multilstm.multi_bilstm_sequence(
                      n, None, *a), multi, tuple(range(2 * n, 4 * n))),
        "fused": (bilstm.bilstm_sequence_fused,
                  pallas_lstm.bilstm_sequence_fused, fused, (1, 2, 5, 6)),
    }


@pytest.mark.parametrize("op", ["merged", "single", "multi", "fused"])
def test_op_default_gradients_equal_jax(op):
    rng = np.random.RandomState(31)
    port_op, jax_op, args, transposed = _ops(rng)[op]
    outs, vjp = jax.vjp(jax_op, *map(jnp.asarray, args))
    dh = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    want = vjp(tuple(map(jnp.asarray, dh)))
    leaves = [(_t(a.T) if k in transposed else _t(a)).requires_grad_(True)
              for k, a in enumerate(args)]
    got_h = port_op(*leaves)
    got = torch.autograd.grad(got_h, leaves, [_t(d) for d in dh])
    for g, r in zip(got_h, outs):
        _rel_close(g, r, f"{op} h")
    for k, (g, r) in enumerate(zip(got, want)):
        _rel_close(g, _f32(r).T if k in transposed else r, f"{op} grad {k}")


def test_lstm_layer_default_equals_jax():
    """``LSTM`` with no residual dtype against JAX's (its field None), on
    the merged route (B8: JAX's kernels take B >= 8)."""
    rng = np.random.RandomState(32)
    x = rng.randn(8, T, I).astype(np.float32)
    target = rng.randn(8, T, 2 * H).astype(np.float32)
    mod = jl.LSTM(H, num_layers=1, bidirectional=True)
    params = mod.init(jax.random.PRNGKey(3), x)["params"]
    want = jax.grad(lambda p: jnp.mean(jnp.square(
        mod.apply({"params": p}, x) - target)))(params)
    ours = tl.LSTM(I, H, 1, torch.Generator())
    state = {}
    for name, value in params.items():
        kind, side, sfx = name.split("_", 2)
        key = f"{'weight' if kind == 'w' else 'bias'}_{side}_{sfx}"
        state[key] = _t(value).T if kind == "w" else _t(value)
    ours.load_state_dict(state)
    torch.mean(torch.square(ours(_t(x)) - _t(target))).backward()
    past = total = 0
    for name, value in want.items():
        kind, side, sfx = name.split("_", 2)
        key = f"{'weight' if kind == 'w' else 'bias'}_{side}_{sfx}"
        g = _f32(getattr(ours, key).grad)
        g = g.T if kind == "w" else g
        w = _f32(value)
        assert_dw_close(g, w, key)
        past += int((np.abs(g - w) > TOL * float(np.abs(w).max())).sum())
        total += w.size
    assert past <= FLIP_SHARE * total, (past, total)
