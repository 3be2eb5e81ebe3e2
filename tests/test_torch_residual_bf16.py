"""bfloat16 residuals: the port's plain versions and autograd Functions
(CPU) against the JAX package's kernels in interpret mode at
``residual_dtype=bfloat16``, the JAX default.

The merged op (``_bd_fwd``, ``_bd_bwd_call``, ``bilstm_sequence``'s VJP)
stores g, c and dxp in bfloat16 and reads dh in bfloat16; the
multi-stream op (``pallas_multilstm._fwd``, ``_bwd_call``,
``multi_bilstm_sequence``'s VJP) stores g and c in bfloat16 and keeps dh
and dx in float32. Both round dW_hh's operands to bfloat16.

Tolerances, each stated where it is used:
- h (float32): 1e-5 absolute, as the float32 tests;
- g, c, dxp (bfloat16): one bfloat16 ulp of the element, element by
  element. Both sides round a float32 value that float32 sums in another
  order make; where those straddle a rounding boundary the two round to
  neighbouring bfloat16 values. Where a sum cancels (d_pre near zero) its
  float32 noise, 1e-6 of the tensor's largest magnitude, is allowed too;
- dxp of a whole Function (forward, then backward on each side's own
  residuals): two bfloat16 ulps. The two forwards' g and c may already
  round to neighbouring values (the one-ulp case above), and the
  gradient reads them;
- dW_hh: 2^-8 of its largest magnitude (its operands are rounded alike,
  the float32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_lstm, pallas_multilstm
from speechsplit_tpu_torch.ops import bilstm, lstm, multi_bilstm
from tests.jax_interpret import interpret
from tests.test_pallas_multilstm import STREAMS

T = 16
B = 8
H_TOL = 1e-5
NOISE = 1e-6
DW_TOL = 2.0 ** -8
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _f32(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy (bfloat16 widened)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def assert_within_one_ulp(got, want, what: str, ulps: int = 1) -> None:
    """Element by element: |got - want| <= ``ulps`` bfloat16 ulps of the
    larger magnitude, plus float32 noise of NOISE x the largest
    magnitude."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, what
    bound = ulps * bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
    bound = bound + NOISE * float(np.abs(w).max())
    err = np.abs(g - w)
    worst = int(np.argmax(err - bound))
    assert (err <= bound).all(), (
        what, float(err.flat[worst]), float(bound.flat[worst]),
        float(w.flat[worst]))


def assert_dw_close(got, want, what: str) -> None:
    """max |got - want| <= 2^-8 x max |want|."""
    g, w = _f32(got), _f32(want)
    err = float(np.abs(g - w).max())
    assert err <= DW_TOL * float(np.abs(w).max()), (what, err)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _merged_inputs(h):
    """xp_f, xp_b [T, B, 4h]; w_f, w_b in the JAX layout [h, 4h];
    cotangents dh_f, dh_b [T, B, h]."""
    rng = np.random.RandomState(700 + h)
    xp = [rng.randn(T, B, 4 * h).astype(np.float32) for _ in "fb"]
    w = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32) for _ in "fb"]
    dh = [rng.randn(T, B, h).astype(np.float32) for _ in "fb"]
    return xp, w, dh


WIDTHS = pytest.mark.parametrize("h", [8, 32])


@WIDTHS
def test_forward_reference_matches_bd_fwd_bf16(h):
    xp, w, _ = _merged_inputs(h)
    want = pallas_lstm._bd_fwd(*map(jnp.asarray, xp + w),
                               residual_dtype=jnp.bfloat16)
    got = bilstm.bilstm_forward_reference(
        *map(_t, xp), *(_t(x.T) for x in w), residual_dtype=BF16)
    assert [g.dtype for g in got] == [torch.float32] * 2 + [BF16] * 4
    for g, r in zip(got[:2], want[:2]):  # h: float32
        np.testing.assert_allclose(_f32(g), _f32(r), atol=H_TOL)
    for name, g, r in zip(("g_f", "g_b", "c_f", "c_b"), got[2:], want[2:]):
        assert r.dtype == jnp.bfloat16
        assert_within_one_ulp(g, r, name)


@WIDTHS
def test_backward_reference_matches_bd_bwd_call_bf16(h):
    xp, w, dh = _merged_inputs(h)
    fwd = pallas_lstm._bd_fwd(*map(jnp.asarray, xp + w),
                              residual_dtype=jnp.bfloat16)
    # the same bfloat16 residuals and cotangents into both
    dh_bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in dh]
    want = pallas_lstm._bd_bwd_call(*dh_bf, *fwd[2:], *map(jnp.asarray, w),
                                    dx_dtype=jnp.bfloat16)
    to_port = [_t(_f32(x)).to(BF16) for x in (*dh_bf, *fwd[2:])]
    got = bilstm.bilstm_backward_reference(*to_port, *(_t(x.T) for x in w))
    for name, g, r in zip(("dx_f", "dx_b"), got, want):
        assert g.dtype == BF16 and r.dtype == jnp.bfloat16
        assert_within_one_ulp(g, r, name)


@WIDTHS
def test_function_grads_match_jax_vjp_bf16(h):
    xp, w, dh = _merged_inputs(h)
    outs, vjp = jax.vjp(
        lambda *a: pallas_lstm.bilstm_sequence(*a, jnp.bfloat16),
        *map(jnp.asarray, xp + w))
    want = vjp(tuple(map(jnp.asarray, dh)))  # dxp_f, dxp_b, dw_f, dw_b
    inputs = [_t(x).requires_grad_(True) for x in xp] + [
        _t(x.T).requires_grad_(True) for x in w]
    got_h = bilstm.bilstm_sequence(*inputs, residual_dtype=BF16)
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dh])
    for g, r in zip(got_h, outs):
        np.testing.assert_allclose(_f32(g), _f32(r), atol=H_TOL)
    for name, g, r in zip(("dxp_f", "dxp_b"), got[:2], want[:2]):
        assert g.dtype == torch.float32  # back to autograd in xp's dtype
        assert_within_one_ulp(g, r, name, ulps=2)
    for name, g, r in zip(("dw_f", "dw_b"), got[2:], want[2:]):
        assert_dw_close(g, _f32(r).T, name)  # torch's [4H, H] layout
    assert not any(bilstm.LAUNCHES.values())


def _multi_inputs(streams):
    rng = np.random.RandomState(900 + len(streams))
    xs, ws, dhs = [], [], []
    for four_h, h in streams:
        for _ in range(2):
            xs.append(rng.randn(T, B, four_h).astype(np.float32))
            ws.append((rng.randn(h, four_h) / np.sqrt(h)).astype(np.float32))
            dhs.append(rng.randn(T, B, h).astype(np.float32))
    return xs, ws, dhs


def test_multi_forward_reference_matches_fwd_bf16():
    xs, ws, _ = _multi_inputs(STREAMS)
    n, d2 = len(STREAMS), 2 * len(STREAMS)
    want = pallas_multilstm._fwd(n, jnp.bfloat16, *map(jnp.asarray, xs + ws))
    got = multi_bilstm.multi_bilstm_forward_reference(
        n, *map(_t, xs), *(_t(w.T) for w in ws), residual_dtype=BF16)
    for g, r in zip(got[:d2], want[:d2]):
        np.testing.assert_allclose(_f32(g), _f32(r), atol=H_TOL)
    for k, (g, r) in enumerate(zip(got[d2:], want[d2:])):
        assert g.dtype == BF16 and r.dtype == jnp.bfloat16
        assert_within_one_ulp(g, r, f"{'gc'[k // d2]}{k % d2}")


def test_multi_backward_reference_matches_bwd_call_bf16():
    xs, ws, dhs = _multi_inputs(STREAMS)
    n, d2 = len(STREAMS), 2 * len(STREAMS)
    fwd = pallas_multilstm._fwd(n, jnp.bfloat16, *map(jnp.asarray, xs + ws))
    g, c = fwd[d2:2 * d2], fwd[2 * d2:]
    want = pallas_multilstm._bwd_call(n, *map(jnp.asarray, dhs), *g, *c, *c,
                                      *map(jnp.asarray, ws))
    got = multi_bilstm.multi_bilstm_backward_reference(
        n, *map(_t, dhs), *(_t(_f32(x)).to(BF16) for x in (*g, *c)),
        *(_t(w.T) for w in ws))
    for d, (gx, r) in enumerate(zip(got, want)):
        # dx float32 on both sides (the multi-stream VJP keeps it so)
        assert gx.dtype == torch.float32 and r.dtype == jnp.float32
        np.testing.assert_allclose(_f32(gx), _f32(r), atol=H_TOL,
                                   rtol=H_TOL, err_msg=f"dx{d}")


def test_multi_function_grads_match_jax_vjp_bf16():
    xs, ws, dhs = _multi_inputs(STREAMS)
    n, d2 = len(STREAMS), 2 * len(STREAMS)
    outs, vjp = jax.vjp(
        lambda *a: pallas_multilstm.multi_bilstm_sequence(n, jnp.bfloat16,
                                                          *a),
        *map(jnp.asarray, xs + ws))
    want = vjp(tuple(map(jnp.asarray, dhs)))
    inputs = [_t(x).requires_grad_(True) for x in xs] + [
        _t(w.T).requires_grad_(True) for w in ws]
    got_h = multi_bilstm.multi_bilstm_sequence(n, *inputs,
                                               residual_dtype=BF16)
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dhs])
    for g, r in zip(got_h, outs):
        np.testing.assert_allclose(_f32(g), _f32(r), atol=H_TOL)
    for d in range(d2):  # dxp: float32 on both sides
        np.testing.assert_allclose(_f32(got[d]), _f32(want[d]), atol=H_TOL,
                                   rtol=H_TOL, err_msg=f"dxp{d}")
    for d in range(d2):
        assert_dw_close(got[d2 + d], _f32(want[d2 + d]).T, f"dw{d}")
    assert not any(multi_bilstm.LAUNCHES.values())


def test_bf16_residuals_where_the_port_saves_float32_raise():
    """Every route saves bfloat16 residuals under autograd: the
    single-direction one, the fused forward and the multi-stream block
    plans (which once saved float32 only and raised): each one's output
    has the float32-residual path's shape and dtype, under autograd and
    under no_grad, and its autograd Function's g and c are the plain
    forward's, rounded to bfloat16."""
    rng = np.random.RandomState(3)
    xp = _t(rng.randn(4, 2, 32).astype(np.float32)).requires_grad_(True)
    w = _t(rng.randn(32, 8).astype(np.float32)).requires_grad_(True)
    want = lstm.lstm_sequence(xp, w, False)
    got = lstm.lstm_sequence(xp, w, False, BF16)
    assert (got.shape, got.dtype) == (want.shape, torch.float32)
    assert type(got.grad_fn).__name__ == "LSTMFunctionBackward"
    with torch.no_grad():
        got = lstm.lstm_sequence(xp, w, False, BF16)
    assert (got.shape, got.dtype) == (want.shape, torch.float32)
    x = _t(rng.randn(4, 2, 5).astype(np.float32)).requires_grad_(True)
    wi = _t(rng.randn(32, 5).astype(np.float32))
    b = _t(rng.randn(32).astype(np.float32))
    fused = bilstm.bilstm_sequence_fused(x, wi, wi, b, b, w, w, BF16)
    assert type(fused[0].grad_fn).__name__ == "BiLSTMFusedFunctionBackward"
    plain = bilstm.bilstm_fused_forward_reference(x, wi, wi, b, b, w, w,
                                                  BF16)
    assert [t.dtype for t in plain[2:]] == [BF16] * 4
    for g, r in zip(fused, plain[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with torch.no_grad():
        lean = bilstm.bilstm_sequence_fused(x, wi, wi, b, b, w, w, BF16)
    for g, r in zip(lean, plain[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    wide = _t(rng.randn(4, 2, 4 * 33).astype(np.float32)).requires_grad_(True)
    w33 = _t(rng.randn(4 * 33, 33).astype(np.float32))
    got = multi_bilstm.multi_bilstm_sequence(1, wide, wide, w33, w33,
                                             residual_dtype=BF16)
    assert type(got[0].grad_fn).__name__ == "MultiBiLSTMFunctionBackward"
    plain = multi_bilstm.multi_bilstm_forward_reference(
        1, wide, wide, w33, w33, residual_dtype=BF16)
    assert [t.dtype for t in plain[2:]] == [BF16] * 4
    for g, r in zip(got, plain[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with torch.no_grad():
        lean = multi_bilstm.multi_bilstm_sequence(1, wide, wide, w33, w33,
                                                  residual_dtype=BF16)
    for g, r in zip(lean, plain[:2]):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="residual_dtype"):
        bilstm.bilstm_sequence(xp, xp, w, w, torch.float16)
