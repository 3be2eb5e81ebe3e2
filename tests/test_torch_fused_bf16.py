"""The fused-projection BiLSTM layer at bfloat16: the port's plain
versions, ``BiLSTMFusedFunction`` and the ``LSTM`` layer under
``PROJ_FUSION="auto"`` (CPU) against the JAX package's
``bilstm_sequence_fused`` (``_bdp_fwd``, ``_bdp_infer`` and its custom
VJP, in interpret mode) at bfloat16 compute (x, W_ih and W_hh bfloat16,
the biases float32) and at bfloat16 residuals beside float32 compute (the
default config). B=16, so that JAX's plan fuses at either dtype (its
bfloat16 tiles need B a multiple of 16). On the card the fused kernels
are held to these plain versions (chip_smoke.py's ``[kernel
bilstm_fused_* bf16]`` lines).

Bars, stated where they are used: tests/test_torch_compute_bf16.py's
flip bars wherever W_hh is bfloat16 (its recurrence rounds h_{t-1}, and
d_pre in the gradient), with two ulps for a gradient of the whole
Function; at float32 W tests/test_torch_residual_bf16.py's (h 1e-5, g
and c one bfloat16 ulp, dxp two); every weight gradient 2^-8 of its
largest magnitude plus one bfloat16 ulp of the element (dW_hh's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.models import layers as jl
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.models import layers as tl
from speechsplit_tpu_torch.ops import bilstm
from tests.test_torch_compute_bf16 import (
    BF16,
    F32,
    _jdt,
    _tdt,
    assert_dw_close,
    assert_flips_within,
    interpret,
)
from tests.test_torch_fused_bilstm import _graph_nodes
from tests.test_torch_residual_bf16 import (
    H_TOL,
    T,
    _f32,
    _t,
    assert_within_one_ulp,
)

B, H, I = 16, 8, 12
# (compute dtype, residual dtype): bfloat16 compute at both residual
# dtypes, and the default config's float32 compute at bfloat16 residuals
PRECISIONS = pytest.mark.parametrize(
    "cd,rd", [("bfloat16", "bfloat16"), ("bfloat16", "float32"),
              ("float32", "bfloat16")])


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)
    monkeypatch.setattr(pallas_lstm, "PROJ_FUSION", "auto")
    monkeypatch.setattr(bilstm, "PROJ_FUSION", "auto")


def _fused_inputs(cd, seed=0, h=H, i=I):
    """JAX's (x, wi_f, wi_b, b_f, b_b, w_f, w_b) (x and the weights in
    ``cd``, the biases float32), the port's same values in its layouts,
    and cotangents dh_f, dh_b [T, B, h]."""
    rng = np.random.RandomState(1900 + 7 * h + i + seed)
    x = rng.randn(T, B, i).astype(np.float32)
    wi = [(rng.randn(i, 4 * h) / np.sqrt(i)).astype(np.float32)
          for _ in "fb"]
    bias = [(0.1 * rng.randn(4 * h)).astype(np.float32) for _ in "fb"]
    w = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32) for _ in "fb"]
    dh = [rng.randn(T, B, h).astype(np.float32) for _ in "fb"]
    jargs = [jnp.asarray(a).astype(_jdt(cd)) for a in (x, *wi)] + [
        jnp.asarray(b) for b in bias] + [
        jnp.asarray(a).astype(_jdt(cd)) for a in w]
    targs = [_t(_f32(a)).to(_tdt(cd)) for a in jargs[:3]] + [
        _t(b) for b in bias] + [_t(_f32(a)) .to(_tdt(cd)) for a in jargs[5:]]
    for k in (1, 2, 5, 6):  # torch's [4H, I] and [4H, H] layouts
        targs[k] = targs[k].t().contiguous()
    assert pallas_lstm.fused_proj_plan(T, B, h, i, _jdt(cd))
    assert bilstm.fused_proj_plan(T, B, h, i, _tdt(cd))
    return jargs, targs, dh


def _assert_recurrence_out(got, want, what, cd, ulps=1):
    """A recurrence's output: the flip bars at bfloat16 W; at float32 W
    1e-5 (float32) or ``ulps`` bfloat16 ulps (bfloat16)."""
    if cd == "bfloat16":
        assert_flips_within(got, want, what, ulps=ulps)
    elif got.dtype == BF16:
        assert_within_one_ulp(got, want, what, ulps=ulps)
    else:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=H_TOL,
                                   err_msg=what)


@PRECISIONS
def test_fused_forward_reference_matches_bdp_fwd(cd, rd):
    """The residual-saving forward: h float32, g and c in the residual
    dtype, as ``_bdp_fwd`` stores them."""
    jargs, targs, _ = _fused_inputs(cd)
    want = pallas_lstm._bdp_fwd(*jargs, residual_dtype=_jdt(rd))
    got = bilstm.bilstm_fused_forward_reference(*targs,
                                                residual_dtype=_tdt(rd))
    assert [g.dtype for g in got] == [F32] * 2 + [_tdt(rd)] * 4
    for name, g, r in zip(("h_f", "h_b", "g_f", "g_b", "c_f", "c_b"), got,
                          want):
        assert g.shape == r.shape
        _assert_recurrence_out(g, r, name, cd)


def test_fused_lean_matches_bilstm_sequence_fused_bf16():
    """The lean op at bfloat16 compute (no grad: the plain lean
    version) against ``bilstm_sequence_fused``: h float32."""
    jargs, targs, _ = _fused_inputs("bfloat16", seed=1)
    want = pallas_lstm.bilstm_sequence_fused(*jargs, jnp.bfloat16)
    got = bilstm.bilstm_sequence_fused(*targs, residual_dtype=BF16)
    for g, r in zip(got, want):
        assert g.dtype == F32 and g.grad_fn is None
        assert_flips_within(g, r, "h")
    assert not any(bilstm.LAUNCHES.values())


@PRECISIONS
def test_fused_function_matches_jax_vjp(cd, rd):
    """``BiLSTMFusedFunction`` against ``_bdp_vjp_fwd``/``_bdp_vjp_bwd``
    (the custom VJP's own rules): h; dx in x's dtype; dW_ih, dW_hh in the
    weights' (rounded from float32 sums of operands rounded to the
    residual dtype); db float32."""
    jargs, targs, dh = _fused_inputs(cd, seed=2)
    outs, res = pallas_lstm._bdp_vjp_fwd(*jargs, _jdt(rd))
    want = pallas_lstm._bdp_vjp_bwd(_jdt(rd), res,
                                    tuple(map(jnp.asarray, dh)))
    inputs = [t.clone().requires_grad_(True) for t in targs]
    got_h = bilstm.bilstm_sequence_fused(*inputs, residual_dtype=_tdt(rd))
    assert type(got_h[0].grad_fn).__name__ == "BiLSTMFusedFunctionBackward"
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dh])
    for g, r in zip(got_h, outs):
        _assert_recurrence_out(g, r, "h", cd)
    names = ("dx", "dwi_f", "dwi_b", "db_f", "db_b", "dw_f", "dw_b")
    for k, (name, g, r) in enumerate(zip(names, got, want)):
        assert g.dtype == targs[k].dtype, name
        assert _tdt(str(r.dtype)) == g.dtype, name
        if k == 0:
            # dx = dxp W_ih, summed over 4H of dxp's possible flips
            assert_dw_close(g, r, name)
        else:
            assert_dw_close(g, _f32(r).T if k in (1, 2, 5, 6) else r, name)
    assert not any(bilstm.LAUNCHES.values())


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
def test_lstm_fused_route_matches_jax(rng, monkeypatch, cd):
    """A 2-layer ``LSTM`` under ``PROJ_FUSION="auto"`` at bfloat16
    residuals and compute ``cd`` against JAX's layer with fusion on: the
    fused Function runs (no grad: the lean fused op), the output and every
    parameter's gradient within the flip bars (bfloat16 compute) or
    within 2^-8 of their largest magnitude (float32 compute: the
    residuals round)."""
    x = rng.randn(B, T, I).astype(np.float32)
    target = rng.randn(B, T, 2 * H).astype(np.float32)
    mod = jl.LSTM(H, num_layers=2, bidirectional=True, dtype=_jdt(cd),
                  residual_dtype=jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(5), x)["params"]

    def jax_loss(p):
        return jnp.mean(jnp.square(mod.apply({"params": p}, x) - target))

    want_out = mod.apply({"params": params}, x)
    want_grads = jax.grad(jax_loss)(params)
    ours = tl.LSTM(I, H, 2, torch.Generator(), dtype=_tdt(cd),
                   residual_dtype=BF16)
    state = {}
    for name, value in params.items():
        kind, side, sfx = name.split("_", 2)
        key = f"{'weight' if kind == 'w' else 'bias'}_{side}_{sfx}"
        state[key] = _t(value).T if kind == "w" else _t(value)
    ours.load_state_dict(state)
    lean_calls = []
    real = bilstm.bilstm_sequence_fused_reference

    def spy(*args):
        lean_calls.append(args[0].dtype)
        return real(*args)

    monkeypatch.setattr(bilstm, "bilstm_sequence_fused_reference", spy)
    with torch.no_grad():
        lean = ours(_t(x))
    assert lean_calls == [_tdt(cd)] * 2  # the lean fused op, a layer each
    out = ours(_t(x))
    assert "BiLSTMFusedFunctionBackward" in _graph_nodes(out)
    torch.mean(torch.square(out - _t(target))).backward()
    for got in (lean, out.detach()):
        if cd == "bfloat16":
            assert_flips_within(got, want_out, "out")
        else:
            np.testing.assert_allclose(_f32(got), _f32(want_out), atol=H_TOL)
    for name, value in want_grads.items():
        kind, side, sfx = name.split("_", 2)
        key = f"{'weight' if kind == 'w' else 'bias'}_{side}_{sfx}"
        ref = _f32(value).T if kind == "w" else _f32(value)
        assert_dw_close(getattr(ours, key).grad, ref, key)
    assert not any(bilstm.LAUNCHES.values())
