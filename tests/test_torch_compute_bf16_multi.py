"""bfloat16 compute in the multi-stream op: the port's plain versions
and ``MultiBiLSTMFunction`` (CPU) against ``pallas_multilstm``'s kernels
in interpret mode at the generator's encoder widths (8, 32, 1), W_hh
bfloat16 for H >= 2 and float32 for the H=1 rhythm stream in one call
(``_recurrent_dtype``), xp, h and dx float32, at both residual dtypes.
The bars are tests/test_torch_compute_bf16.py's, stated there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_multilstm
from speechsplit_tpu_torch.ops import multi_bilstm
from tests.test_pallas_multilstm import STREAMS
from tests.test_torch_compute_bf16 import (
    BF16,
    F32,
    RESIDUALS,
    _bf16_w,
    _jdt,
    _tdt,
    assert_dw_close,
    assert_flips_within,
    interpret,
)
from tests.test_torch_residual_bf16 import B, T, _f32, _t


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _multi_inputs(seed=0):
    """STREAMS (8, 32, 1) as both packages take them: xp float32, W_hh
    bfloat16 for H >= 2 and float32 for the H=1 stream."""
    rng = np.random.RandomState(1500 + seed)
    xs, jws, tws, dhs = [], [], [], []
    for four_h, h in STREAMS:
        for _ in range(2):
            xs.append(rng.randn(T, B, four_h).astype(np.float32))
            w = (rng.randn(h, four_h) / np.sqrt(h)).astype(np.float32)
            if h >= 2:
                jw, tw = _bf16_w(w)
            else:
                jw, tw = jnp.asarray(w), _t(w.T)
            jws.append(jw)
            tws.append(tw)
            dhs.append(rng.randn(T, B, h).astype(np.float32))
    assert {w.dtype for w in tws} == {BF16, F32}  # mixed in one call
    return xs, jws, tws, dhs


@RESIDUALS
def test_multi_forward_reference_matches_fwd(rd):
    xs, jws, tws, _ = _multi_inputs()
    n, d2 = len(STREAMS), 2 * len(STREAMS)
    want = pallas_multilstm._fwd(n, _jdt(rd), *map(jnp.asarray, xs), *jws)
    got = multi_bilstm.multi_bilstm_forward_reference(
        n, *map(_t, xs), *tws, residual_dtype=_tdt(rd))
    for g, r in zip(got[:d2], want[:d2]):
        assert g.dtype == F32
        assert_flips_within(g, r, "h")
    for k, (g, r) in enumerate(zip(got[d2:], want[d2:])):
        assert g.dtype == _tdt(rd)
        assert_flips_within(g, r, f"{'gc'[k // d2]}{k % d2}")


@RESIDUALS
def test_multi_backward_reference_matches_bwd_call(rd):
    xs, jws, tws, dhs = _multi_inputs(seed=1)
    n, d2 = len(STREAMS), 2 * len(STREAMS)
    fwd = pallas_multilstm._fwd(n, _jdt(rd), *map(jnp.asarray, xs), *jws)
    g, c = fwd[d2:2 * d2], fwd[2 * d2:]
    want = pallas_multilstm._bwd_call(n, *map(jnp.asarray, dhs), *g, *c, *c,
                                      *jws)
    got = multi_bilstm.multi_bilstm_backward_reference(
        n, *map(_t, dhs), *(_t(_f32(x)).to(_tdt(rd)) for x in (*g, *c)),
        *tws)
    for d, (gx, r) in enumerate(zip(got, want)):
        assert gx.dtype == F32 and r.dtype == jnp.float32
        assert_flips_within(gx, r, f"dx{d}")


@RESIDUALS
def test_multi_function_matches_jax_vjp(rd):
    """``MultiBiLSTMFunction`` with mixed W dtypes in one call: dxp
    float32, each dW in its W's dtype."""
    xs, jws, tws, dhs = _multi_inputs(seed=2)
    n, d2 = len(STREAMS), 2 * len(STREAMS)
    # the custom VJP's own rules (what jax.vjp runs), called directly
    outs, res = pallas_multilstm._vjp_fwd(n, _jdt(rd), *map(jnp.asarray, xs),
                                          *jws)
    want = pallas_multilstm._vjp_bwd(n, _jdt(rd), res,
                                     tuple(map(jnp.asarray, dhs)))

    inputs = [_t(x).requires_grad_(True) for x in xs] + [
        w.clone().requires_grad_(True) for w in tws]
    got_h = multi_bilstm.multi_bilstm_sequence(n, *inputs,
                                               residual_dtype=_tdt(rd))
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dhs])
    for g, r in zip(got_h, outs):
        assert_flips_within(g, r, "h")
    for d in range(d2):
        assert got[d].dtype == F32
        assert_flips_within(got[d], want[d], f"dxp{d}")

    for d in range(d2):
        assert got[d2 + d].dtype == tws[d].dtype
        assert want[d2 + d].dtype == jws[d].dtype
        assert_dw_close(got[d2 + d], _f32(want[d2 + d]).T, f"dw{d}")
    assert not any(multi_bilstm.LAUNCHES.values())
