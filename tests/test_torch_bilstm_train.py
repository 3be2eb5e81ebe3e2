"""The port's BiLSTM training path (plain versions, CPU) against the
JAX package's merged-bidirectional kernels in interpret mode: the
residual-saving forward (_bd_fwd), the gradient recurrence
(_bd_bwd_call), and the gradients of bilstm_sequence's custom VJP
against BiLSTMFunction's. Also the dispatch between the lean path and
the Function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.ops import bilstm
from tests.jax_interpret import at_test_fold

T = 16
TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    at_test_fold(monkeypatch)
    pallas_lstm.FORCE_INTERPRET = True
    prev = pallas_lstm.RESIDUAL_DTYPE
    pallas_lstm.RESIDUAL_DTYPE = jnp.float32
    yield
    pallas_lstm.FORCE_INTERPRET = False
    pallas_lstm.RESIDUAL_DTYPE = prev


def _inputs(h, b):
    """xp_f, xp_b [T, b, 4h]; w_f, w_b in the JAX layout [h, 4h];
    cotangents dh_f, dh_b [T, b, h]."""
    rng = np.random.RandomState(1000 * h + b)
    xp = [rng.randn(T, b, 4 * h).astype(np.float32) for _ in "fb"]
    w = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32) for _ in "fb"]
    dh = [rng.randn(T, b, h).astype(np.float32) for _ in "fb"]
    return xp, w, dh


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


SHAPES = pytest.mark.parametrize(
    "h,b", [(h, b) for h in (1, 8, 32) for b in (1, 8)])


@SHAPES
def test_forward_reference_matches_bd_fwd(h, b):
    xp, w, _ = _inputs(h, b)
    want = pallas_lstm._bd_fwd(*map(jnp.asarray, xp + w),
                               residual_dtype=jnp.float32)
    got = bilstm.bilstm_forward_reference(*map(_t, xp), *(_t(x.T) for x in w))
    assert len(got) == len(want) == 6
    for g, r in zip(got, want):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)


@SHAPES
def test_backward_reference_matches_bd_bwd_call(h, b):
    xp, w, dh = _inputs(h, b)
    fwd = pallas_lstm._bd_fwd(*map(jnp.asarray, xp + w),
                              residual_dtype=jnp.float32)
    residuals = [np.asarray(r) for r in fwd[2:]]  # g_f, g_b, c_f, c_b
    want = pallas_lstm._bd_bwd_call(*map(jnp.asarray, dh), *fwd[2:],
                                    *map(jnp.asarray, w))
    got = bilstm.bilstm_backward_reference(
        *map(_t, dh), *map(_t, residuals), *(_t(x.T) for x in w))
    for g, r in zip(got, want):
        assert g.shape == (T, b, 4 * h)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)


@SHAPES
def test_function_grads_match_jax_vjp(h, b):
    xp, w, dh = _inputs(h, b)
    outs, vjp = jax.vjp(pallas_lstm.bilstm_sequence, *map(jnp.asarray, xp + w))
    want = vjp(tuple(map(jnp.asarray, dh)))  # dxp_f, dxp_b, dw_f, dw_b
    inputs = [_t(x).requires_grad_(True) for x in xp] + [
        _t(x.T).requires_grad_(True) for x in w]
    got_h = bilstm.bilstm_sequence(*inputs, torch.float32)
    assert type(got_h[0].grad_fn).__name__ == "BiLSTMFunctionBackward"
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dh])
    for g, r in zip(got_h, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=TOL)
    for k, (g, r) in enumerate(zip(got, want)):
        r = np.asarray(r)
        if k >= 2:  # dW in torch's [4H, H] layout
            r = r.T
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, rtol=TOL)
    assert not any(bilstm.LAUNCHES.values())


def test_dispatch_lean_under_no_grad_function_under_grad():
    xp, w, _ = _inputs(8, 2)
    leaves = [_t(x).requires_grad_(True) for x in xp] + [
        _t(x.T).requires_grad_(True) for x in w]
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            out = bilstm.bilstm_sequence(*leaves)
        assert all(o.grad_fn is None for o in out)
    plain = [x.detach() for x in leaves]
    assert bilstm.bilstm_sequence(*plain)[0].grad_fn is None
    out = bilstm.bilstm_sequence(*leaves)
    assert type(out[0].grad_fn).__name__ == "BiLSTMFunctionBackward"
    # only the recurrent weight requires grad: still the Function, and
    # a cotangent on one output only
    mixed = plain[:2] + leaves[2:]
    out = bilstm.bilstm_sequence(*mixed)
    (dw_f, dw_b) = torch.autograd.grad(out[0].sum(), mixed[2:])
    assert float(dw_b.abs().max()) == 0.0 and float(dw_f.abs().max()) > 0.0
    assert not any(bilstm.LAUNCHES.values())


def test_backward_wrapper_rejects_bad_residuals():
    g = torch.zeros(4, 2, 32)
    c = torch.zeros(4, 2, 8)
    w = torch.zeros(32, 8)
    with pytest.raises(ValueError, match="dh_f"):
        bilstm._check_residuals(torch.zeros(4, 2, 9), c, g, g, c, c, w)
    # dh, g and c in one residual dtype, float32 or bfloat16: mixed ones
    # and other dtypes raise
    with pytest.raises(ValueError, match="one residual dtype"):
        bilstm._check_residuals(c, c, g.bfloat16(), g, c, c, w)
    with pytest.raises(ValueError, match="residual_dtype"):
        bilstm._check_residuals(*(x.half() for x in (c, c, g, g, c, c)), w)
    bf = [x.bfloat16() for x in (c, c, g, g, c, c)]
    bilstm._check_residuals(*bf, w)
