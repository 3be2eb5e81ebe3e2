"""The port's multi-stream BiLSTM training path (plain versions, CPU)
against the JAX package's multi-stream kernels in interpret mode: the
residual-saving forward (_fwd), the gradient recurrence (_bwd_call) and
the gradients of multi_bilstm_sequence's custom VJP against
MultiBiLSTMFunction's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_lstm, pallas_multilstm
from speechsplit_tpu_torch.ops import multi_bilstm
from tests.jax_interpret import at_test_fold
from tests.test_pallas_multilstm import STREAMS
from tests.test_torch_multi_bilstm import PLAN_CASES, plan_case_id, plan_inputs

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


def _inputs(streams, b):
    rng = np.random.RandomState(len(streams) * 100 + b)
    xs, ws, dhs = [], [], []
    for four_h, h in streams:
        for _ in range(2):
            xs.append(rng.randn(T, b, four_h).astype(np.float32))
            ws.append((rng.randn(h, four_h) / np.sqrt(h)).astype(np.float32))
            dhs.append(rng.randn(T, b, h).astype(np.float32))
    return xs, ws, dhs


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


# the generator's three streams at B=8 and the F0 converter's two at
# B=1 (each interpret-mode shape costs seconds of compile)
CASES = pytest.mark.parametrize(
    "streams,b", [(STREAMS, 8), (STREAMS[1:], 1)],
    ids=lambda v: (f"b{v}" if isinstance(v, int) else
                   "generator" if len(v) == 3 else "f0_converter"))


@CASES
def test_forward_reference_matches_fwd(streams, b):
    xs, ws, _ = _inputs(streams, b)
    n = len(streams)
    want = pallas_multilstm._fwd(n, jnp.float32, *map(jnp.asarray, xs + ws))
    got = multi_bilstm.multi_bilstm_forward_reference(
        n, *map(_t, xs), *(_t(w.T) for w in ws))
    assert len(got) == len(want) == 6 * n
    for g, r in zip(got, want):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)


@pytest.mark.parametrize("case", PLAN_CASES, ids=plan_case_id)
def test_forward_reference_matches_fwd_on_the_kernel_plans(case):
    t, b, hs = case
    xs, ws = plan_inputs(t, b, hs)
    n = len(hs)
    want = pallas_multilstm._fwd(n, jnp.float32, *map(jnp.asarray, xs + ws))
    got = multi_bilstm.multi_bilstm_forward_reference(
        n, *map(_t, xs), *(_t(w.T) for w in ws))
    assert len(got) == len(want) == 6 * n
    for g, r in zip(got, want):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)


@CASES
def test_backward_reference_matches_bwd_call(streams, b):
    xs, ws, dhs = _inputs(streams, b)
    n, d2 = len(streams), 2 * len(streams)
    fwd = pallas_multilstm._fwd(n, jnp.float32, *map(jnp.asarray, xs + ws))
    g, c = fwd[d2:2 * d2], fwd[2 * d2:]
    want = pallas_multilstm._bwd_call(n, *map(jnp.asarray, dhs), *g, *c, *c,
                                      *map(jnp.asarray, ws))
    got = multi_bilstm.multi_bilstm_backward_reference(
        n, *map(_t, dhs), *(_t(np.asarray(x)) for x in g),
        *(_t(np.asarray(x)) for x in c), *(_t(w.T) for w in ws))
    assert len(got) == d2
    for g_, r in zip(got, want):
        assert g_.shape == r.shape
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), atol=TOL)


@pytest.mark.parametrize("case", PLAN_CASES, ids=plan_case_id)
def test_backward_reference_matches_bwd_call_on_the_kernel_plans(case):
    """The gradient kernel's plans (the lane plan to width 32, the block
    plan for a call with a wider direction) are held to this plain
    version on the card; here it is held to ``_bwd_call`` on the same
    shapes."""
    t, b, hs = case
    xs, ws = plan_inputs(t, b, hs)
    n, d2 = len(hs), 2 * len(hs)
    rng = np.random.RandomState(7 * t + b)
    dhs = [rng.randn(t, b, h).astype(np.float32) for h in hs for _ in (0, 1)]
    fwd = pallas_multilstm._fwd(n, jnp.float32, *map(jnp.asarray, xs + ws))
    g, c = fwd[d2:2 * d2], fwd[2 * d2:]
    want = pallas_multilstm._bwd_call(n, *map(jnp.asarray, dhs), *g, *c, *c,
                                      *map(jnp.asarray, ws))
    got = multi_bilstm.multi_bilstm_backward_reference(
        n, *map(_t, dhs), *(_t(np.asarray(x)) for x in g),
        *(_t(np.asarray(x)) for x in c), *(_t(w.T) for w in ws))
    assert len(got) == len(want) == d2
    for g_, r in zip(got, want):
        assert g_.shape == r.shape
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), atol=TOL)


@CASES
def test_function_grads_match_jax_vjp(streams, b):
    xs, ws, dhs = _inputs(streams, b)
    n, d2 = len(streams), 2 * len(streams)

    def op(*args):
        return pallas_multilstm.multi_bilstm_sequence(n, None, *args)

    outs, vjp = jax.vjp(op, *map(jnp.asarray, xs + ws))
    want = vjp(tuple(map(jnp.asarray, dhs)))
    inputs = [_t(x).requires_grad_(True) for x in xs] + [
        _t(w.T).requires_grad_(True) for w in ws]
    got_h = multi_bilstm.multi_bilstm_sequence(n, *inputs,
                                               residual_dtype=torch.float32)
    assert type(got_h[0].grad_fn).__name__ == "MultiBiLSTMFunctionBackward"
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dhs])
    for g, r in zip(got_h, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=TOL)
    for k, (g, r) in enumerate(zip(got, want)):
        r = np.asarray(r)
        if k >= d2:  # dW in torch's [4H, H] layout
            r = r.T
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, rtol=TOL)
    assert not any(multi_bilstm.LAUNCHES.values())


def test_dispatch_lean_under_no_grad_function_under_grad():
    xs, ws, _ = _inputs(STREAMS[1:], 2)
    leaves = [_t(x).requires_grad_(True) for x in xs] + [
        _t(w.T).requires_grad_(True) for w in ws]
    with torch.no_grad():
        outs = multi_bilstm.multi_bilstm_sequence(2, *leaves)
    assert all(o.grad_fn is None for o in outs)
    outs = multi_bilstm.multi_bilstm_sequence(2, *leaves)
    assert type(outs[0].grad_fn).__name__ == "MultiBiLSTMFunctionBackward"
    # cotangents on some outputs only
    grads = torch.autograd.grad(outs[1].sum() + outs[2].sum(), leaves)
    assert float(grads[0].abs().max()) == 0.0  # h_f0 unused
    assert float(grads[1].abs().max()) > 0.0
    assert not any(multi_bilstm.LAUNCHES.values())


def test_backward_wrapper_rejects_bad_arguments():
    g = torch.zeros(4, 2, 32)
    c = torch.zeros(4, 2, 8)
    with pytest.raises(ValueError, match="expected 8"):
        multi_bilstm.multi_bilstm_backward_reference(1, c, c, g)
    with pytest.raises(ValueError, match="dh"):
        multi_bilstm._check_residuals((torch.zeros(4, 2, 7),), (g,), (c,))
    # g and c in one residual dtype, dh float32: mixed ones raise;
    # bfloat16 residuals run on either plan (a width past 32: the block
    # plan)
    with pytest.raises(ValueError, match="one residual dtype"):
        multi_bilstm._check_residuals((c,), (g,), (c.bfloat16(),))
    with pytest.raises(ValueError, match="float32 dh"):
        multi_bilstm._check_residuals((c.bfloat16(),), (g.bfloat16(),),
                                      (c.bfloat16(),))
    multi_bilstm._check_residuals((c,), (g.bfloat16(),), (c.bfloat16(),))
    wide_g, wide_c = torch.zeros(4, 2, 132), torch.zeros(4, 2, 33)
    multi_bilstm._check_residuals((wide_c,), (wide_g.bfloat16(),),
                                  (wide_c.bfloat16(),))
    # and the plain gradient runs them, dx float32, as on the lane plan
    dh, w = torch.randn(4, 2, 33), torch.randn(132, 33) / 33 ** 0.5
    g, c = torch.rand(4, 2, 132).bfloat16(), torch.randn(4, 2, 33).bfloat16()
    dx = multi_bilstm.multi_bilstm_backward_reference(1, dh, dh, g, g, c, c,
                                                      w, w)
    assert [x.dtype for x in dx] == [torch.float32] * 2
    assert all(torch.isfinite(x).all() for x in dx)
