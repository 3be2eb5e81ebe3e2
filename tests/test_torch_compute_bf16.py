"""bfloat16 compute (``compute_dtype="bfloat16"``): the port's plain
versions, autograd Functions and layers (CPU) against the JAX package's
Pallas kernels in interpret mode and its layers, and the dtype pairs
its models never form (a float32 x and W_ih beside a bfloat16 W_hh in the
fused op, a bfloat16 xp beside a float32 W_hh or into the multi-stream
op, a float32 xp beside bfloat16 residuals) against JAX's ops.

At bfloat16 compute W_hh is bfloat16: a step's product reads h_{t-1}
rounded to bfloat16 (pallas_lstm._cell), the gradient's reads d_pre
rounded to bfloat16 (_cell_bwd), dW_hh is rounded to bfloat16
(_dw_contract). The merged op's xp streams are bfloat16 where the
residuals are too (stream_dtype); the multi-stream op keeps xp float32
and takes W_hh per direction: bfloat16 for H >= 2, float32 for the H=1
rhythm stream (_recurrent_dtype), in one call.

Bars, each stated where it is used (those of
tests/test_torch_residual_bf16.py:10-23, and one allowance of bfloat16
compute):
- h and dx (float32): 1e-5, absolute or relative to the largest
  magnitude where that is above 1;
- bfloat16 outputs (g, c, dx of the kernels): one bfloat16 ulp of the
  element, plus float32 noise of 1e-6 of the tensor's largest magnitude;
- dxp of a whole Function: two ulps (its g and c may already round to
  neighbouring values);
- dW_hh: 2^-8 of its largest magnitude, plus its own bfloat16 rounding
  (one ulp of each element: both sides round their float32 sums);
- flips: a recurrence's product at bfloat16 W reads h_{t-1} (d_pre in
  the gradient) rounded to bfloat16, so a value whose two float32 sums
  (taken in another order) straddle a rounding boundary enters that
  product one bfloat16 ulp apart, and the steps after it carry the
  difference. So at most FLIP_SHARE (2%) of a recurrence's outputs may
  miss the bars above, and those stay within FLIP (2^-8) of the
  tensor's largest magnitude. Measured: h of the multi-stream Function
  (seed 2) 30 of 4096 elements past 1e-5, up to 7.3e-5; dx_b of the
  merged gradient at H=32 (seed 3) 6 of 16,384 elements, up to 5.8e-4
  of its largest magnitude; every other element within the bars;
- a layer's float32 output: 1e-5 relative to its largest magnitude
  (products of rounded operands are exact, the sums' order differs).
"""

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
from tests.test_torch_residual_bf16 import (
    B,
    DW_TOL,
    H_TOL,
    NOISE,
    T,
    _f32,
    _t,
    assert_within_one_ulp,
    bf16_ulp,
)

BF16 = torch.bfloat16
F32 = torch.float32
RESIDUALS = pytest.mark.parametrize("rd", ["float32", "bfloat16"])
LAYER_RTOL = 1e-5
FLIP = 2.0 ** -8
FLIP_SHARE = 0.02


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _jdt(name):
    return jnp.bfloat16 if name == "bfloat16" else jnp.float32


def _tdt(name):
    return BF16 if name == "bfloat16" else F32


def _bf16_w(w: np.ndarray):
    """A JAX-layout [h, 4h] weight as both packages' bfloat16 W_hh: the
    JAX array and torch's [4h, h]."""
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    return jw, _t(_f32(jw).T).to(BF16)


def assert_dw_close(got, want, what: str) -> None:
    """max |got - want| <= 2^-8 x max |want|, plus one bfloat16 ulp of
    the element (both sides round their sums to bfloat16)."""
    g, w = _f32(got), _f32(want)
    bound = DW_TOL * float(np.abs(w).max()) + bf16_ulp(np.abs(w))
    err = np.abs(g - w)
    assert (err <= bound).all(), (what, float((err - bound).max()))


def assert_flips_within(got, want, what: str, ulps: int = 1) -> None:
    """A recurrence's output at bfloat16 W against JAX's: each element
    within ``ulps`` bfloat16 ulps of the larger magnitude plus NOISE x
    the largest (a bfloat16 tensor), or within 1e-5 (a float32 one:
    absolute, or relative to the largest magnitude where that is above
    1), but for at most FLIP_SHARE of them, which stay within FLIP x the
    largest magnitude (see the module docstring)."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, what
    top = float(np.abs(w).max())
    if got.dtype == BF16:
        near = ulps * bf16_ulp(np.maximum(np.abs(g), np.abs(w))) + (
            NOISE * top)
    else:
        near = H_TOL * max(top, 1.0)
    err = np.abs(g - w)
    share = float((err > near).mean())
    assert share <= FLIP_SHARE, (what, share)
    assert float(err.max()) <= FLIP * top, (what, float(err.max()), top)


def _merged_inputs(h, seed=0):
    rng = np.random.RandomState(1400 + h + seed)
    xp = [rng.randn(T, B, 4 * h).astype(np.float32) for _ in "fb"]
    w = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32) for _ in "fb"]
    dh = [rng.randn(T, B, h).astype(np.float32) for _ in "fb"]
    return xp, w, dh


WIDTHS = pytest.mark.parametrize("h", [8, 32])


@WIDTHS
@RESIDUALS
def test_forward_reference_matches_bd_fwd(h, rd):
    """The residual-saving forward at bfloat16 W, its xp stream in the
    residuals' dtype (stream_dtype)."""
    xp, w, _ = _merged_inputs(h)
    jw = [_bf16_w(x) for x in w]
    jxp = [jnp.asarray(x).astype(_jdt(rd)) for x in xp]
    want = pallas_lstm._bd_fwd(*jxp, *(j for j, _ in jw),
                               residual_dtype=_jdt(rd))
    got = bilstm.bilstm_forward_reference(
        *(_t(_f32(x)).to(_tdt(rd)) for x in jxp), *(t for _, t in jw),
        residual_dtype=_tdt(rd))
    assert [g.dtype for g in got] == [F32] * 2 + [_tdt(rd)] * 4
    for g, r in zip(got[:2], want[:2]):  # h: float32
        assert r.dtype == jnp.float32
        assert_flips_within(g, r, "h")
    for name, g, r in zip(("g_f", "g_b", "c_f", "c_b"), got[2:], want[2:]):
        assert_flips_within(g, r, name)


@WIDTHS
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_lean_reference_matches_bd_infer(h, stream):
    """The lean forward at bfloat16 W beside either xp stream: h float32
    within 1e-5 of ``_bd_infer``'s."""
    xp, w, _ = _merged_inputs(h, seed=1)
    jw = [_bf16_w(x) for x in w]
    jxp = [jnp.asarray(x).astype(_jdt(stream)) for x in xp]
    want = pallas_lstm._bd_infer(*jxp, *(j for j, _ in jw))
    got = bilstm.bilstm_sequence(
        *(_t(_f32(x)).to(_tdt(stream)) for x in jxp), *(t for _, t in jw))
    for g, r in zip(got, want):
        assert g.dtype == F32 and r.dtype == jnp.float32
        assert_flips_within(g, r, "h")


def test_reference_rounds_the_staged_operand_not_h():
    """The product reads h_{t-1} rounded to bfloat16 while the h it
    returns stays unrounded float32, at a float32 xp stream too: rounding
    the stored h instead would show here (and pass with a bfloat16
    stream)."""
    xp, w, _ = _merged_inputs(8, seed=2)
    _, tw = _bf16_w(w[0])
    h, _, _ = bilstm.lstm_direction_forward_reference(_t(xp[0]), tw, False)
    assert h.dtype == F32
    assert (h != h.to(BF16).float()).any()
    # one step by hand from the returned h: the product of its rounding
    i, f, g, o = (_t(xp[0][1]) + h[0].to(BF16).float() @ tw.float().t()
                  ).chunk(4, -1)
    c0 = torch.sigmoid(_t(xp[0][0])[:, :8]) * torch.tanh(
        _t(xp[0][0])[:, 16:24])
    c1 = torch.sigmoid(f) * c0 + torch.sigmoid(i) * torch.tanh(g)
    torch.testing.assert_close(h[1], torch.sigmoid(o) * torch.tanh(c1),
                               rtol=0, atol=1e-6)


@WIDTHS
@RESIDUALS
def test_backward_reference_matches_bd_bwd_call(h, rd):
    """The gradient at bfloat16 W on the forward's own residuals, dx in
    the residuals' dtype (one ulp where bfloat16, 1e-5 where float32)."""
    xp, w, dh = _merged_inputs(h, seed=3)
    jw = [_bf16_w(x) for x in w]
    jxp = [jnp.asarray(x).astype(_jdt(rd)) for x in xp]
    fwd = pallas_lstm._bd_fwd(*jxp, *(j for j, _ in jw),
                              residual_dtype=_jdt(rd))
    jdh = [jnp.asarray(x).astype(_jdt(rd)) for x in dh]
    want = pallas_lstm._bd_bwd_call(*jdh, *fwd[2:], *(j for j, _ in jw),
                                    dx_dtype=_jdt(rd))
    to_port = [_t(_f32(x)).to(_tdt(rd)) for x in (*jdh, *fwd[2:])]
    got = bilstm.bilstm_backward_reference(*to_port, *(t for _, t in jw))
    for name, g, r in zip(("dx_f", "dx_b"), got, want):
        assert g.dtype == _tdt(rd)
        assert_flips_within(g, r, name)


@WIDTHS
@RESIDUALS
def test_function_matches_jax_vjp(h, rd):
    """``BiLSTMFunction`` at bfloat16 W against ``bilstm_sequence``'s
    custom VJP: h, dxp (in the primal's dtype: bfloat16 where the stream
    is) and dW_hh (bfloat16, rounded from its float32 sum)."""
    xp, w, dh = _merged_inputs(h, seed=4)
    jw = [_bf16_w(x) for x in w]
    jxp = [jnp.asarray(x).astype(_jdt(rd)) for x in xp]
    # the custom VJP's own rules (what jax.vjp runs), called directly
    outs, res = pallas_lstm._bd_vjp_fwd(*jxp, *(j for j, _ in jw), _jdt(rd))
    want = pallas_lstm._bd_vjp_bwd(_jdt(rd), res,
                                   tuple(map(jnp.asarray, dh)))

    inputs = [_t(_f32(x)).to(_tdt(rd)).requires_grad_(True) for x in jxp] + [
        t.clone().requires_grad_(True) for _, t in jw]
    got_h = bilstm.bilstm_sequence(*inputs, residual_dtype=_tdt(rd))
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dh])
    for g, r in zip(got_h, outs):
        assert_flips_within(g, r, "h")
    for name, g, r in zip(("dxp_f", "dxp_b"), got[:2], want[:2]):
        assert g.dtype == _tdt(rd) and r.dtype == _jdt(rd)
        assert_flips_within(g, r, name, ulps=2)
    for name, g, r in zip(("dw_f", "dw_b"), got[2:], want[2:]):
        assert g.dtype == BF16 and r.dtype == jnp.bfloat16
        assert_dw_close(g, _f32(r).T, name)  # torch's [4H, H] layout
    assert not any(bilstm.LAUNCHES.values())


def _assert_layer_close(got, want, what):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, what
    err = float(np.abs(g - w).max())
    assert err <= LAYER_RTOL * float(np.abs(w).max()), (what, err)


def test_linear_bf16_matches_jax(rng):
    """The value (float32 sums of rounded operands, the bias in float32)
    and the gradients of W and x (rounded to bfloat16, as JAX's
    transpose of its mixed product) against JAX's ``Linear``."""
    x = rng.randn(3, 7, 16).astype(np.float32)
    ct = rng.randn(3, 7, 24).astype(np.float32)
    mod = jl.Linear(24, dtype=jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(0), x)["params"]
    want, vjp = jax.vjp(lambda p, v: mod.apply({"params": p}, v), params, x)
    dparams, dx = vjp(jnp.asarray(ct))
    layer = tl.Linear(16, 24, torch.Generator(), dtype=BF16)
    layer.load_state_dict({
        "linear_layer.weight": _t(params["kernel"]).T,
        "linear_layer.bias": _t(params["bias"]),
    })
    tx = _t(x).requires_grad_(True)
    got = layer(tx)
    got.backward(_t(ct))
    assert got.dtype == F32
    _assert_layer_close(got, want, "y")
    w_grad = layer.linear_layer.weight.grad
    assert torch.equal(w_grad, w_grad.to(BF16).float())  # bfloat16 values
    assert_within_one_ulp(w_grad, _f32(dparams["kernel"]).T, "dW")
    assert_within_one_ulp(tx.grad, dx, "dx")
    _assert_layer_close(layer.linear_layer.bias.grad, dparams["bias"], "db")


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv1d_bf16_matches_jax(rng, dilation):
    """A bfloat16 conv rounds its output before the bias goes on in
    float32 (JAX layers.py:124-135): value within one bfloat16 ulp of
    the rounded sum, the gradients of W and x within one ulp."""
    x = rng.randn(2, 31, 12).astype(np.float32)
    ct = rng.randn(2, 31, 20).astype(np.float32)
    mod = jl.Conv1d(20, kernel_size=5, dilation=dilation, w_init_gain="relu",
                    dtype=jnp.bfloat16)
    params = mod.init(jax.random.PRNGKey(1), x)["params"]
    want, vjp = jax.vjp(lambda p, v: mod.apply({"params": p}, v), params, x)
    dparams, dx = vjp(jnp.asarray(ct))
    layer = tl.Conv1d(12, 20, torch.Generator(), kernel_size=5,
                      dilation=dilation, dtype=BF16)
    layer.load_state_dict({
        "conv.weight": _t(params["kernel"]).permute(2, 1, 0),
        "conv.bias": _t(params["bias"]),
    })
    tx = _t(x).requires_grad_(True)
    got = layer(tx)
    got.backward(_t(ct))
    # the bias after the rounding: without it the output is bfloat16 to
    # the bit, and with it that plus the bias in float32
    bias = layer.conv.bias.detach().clone()
    with torch.no_grad():
        layer.conv.bias.zero_()
        rounded = layer(tx)
    assert torch.equal(rounded, rounded.to(BF16).float())
    assert torch.equal(got.detach(), rounded + bias)
    # JAX's within one bfloat16 ulp of the rounded sum (and float32
    # noise of the bias's addition)
    err = np.abs(_f32(got) - _f32(want))
    bound = bf16_ulp(np.abs(_f32(rounded))) + NOISE * float(
        np.abs(_f32(want)).max())
    assert (err <= bound).all(), float((err - bound).max())
    w_grad = layer.conv.weight.grad
    assert torch.equal(w_grad, w_grad.to(BF16).float())
    assert_within_one_ulp(w_grad.permute(2, 1, 0), dparams["kernel"], "dW")
    assert_within_one_ulp(tx.grad, dx, "dx")


def test_lstm_projection_and_streams_follow_jax(rng):
    """An LSTM's projection follows ``Linear`` and its ``streams`` keep xp
    float32 with W_hh in ``_recurrent_dtype``; the merged route casts xp
    to ``stream_dtype``."""
    layer = tl.LSTM(16, 8, 1, torch.Generator().manual_seed(2), dtype=BF16,
                    residual_dtype=BF16)
    x = _t(rng.randn(B, 5, 16).astype(np.float32))
    xp_f, xp_b, w_f, w_b = layer.streams(x)
    assert (xp_f.dtype, w_f.dtype) == (F32, BF16)
    w_ih = layer.weight_ih_l0
    bias = layer.bias_ih_l0 + layer.bias_hh_l0
    want = x.to(BF16).float() @ w_ih.to(BF16).float().t() + bias
    torch.testing.assert_close(xp_f, want.transpose(0, 1), rtol=0,
                               atol=1e-6)
    rhythm = tl.LSTM(16, 1, 1, torch.Generator(), dtype=BF16)
    assert rhythm.streams(x)[2].dtype == F32  # H = 1 keeps float32
    assert bilstm.stream_dtype(BF16, BF16) == BF16
    assert bilstm.stream_dtype(BF16, F32) == F32
    assert bilstm.stream_dtype(F32, BF16) == F32


def test_checkpoints_load_across_compute_dtypes():
    """Parameters stay float32: a state dict from a model at either
    compute dtype loads into one built at the other."""
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.models import SpeechSplit
    from tests.test_pallas_multilstm import _tiny_config
    import dataclasses

    cfg = SpeechSplitConfig(**dataclasses.asdict(_tiny_config()))
    f32 = SpeechSplit(cfg, torch.Generator().manual_seed(0))
    b16 = SpeechSplit(cfg.replace(compute_dtype="bfloat16"),
                      torch.Generator().manual_seed(1))
    assert {p.dtype for p in b16.parameters()} == {F32}
    assert b16.decoder.lstm.dtype == BF16
    b16.load_state_dict(f32.state_dict(), strict=True)
    f32.load_state_dict(b16.state_dict(), strict=True)


def test_a4c_paths_refuse_bfloat16_compute(monkeypatch):
    """What bfloat16 compute runs, on CPU tensors (the checks are on
    dtypes alone, so the card takes the same calls): the fused op at
    bfloat16 x, W_ih and W_hh, and ``PROJ_FUSION="auto"`` with a bfloat16
    W_hh (once refused, now run and equal to the composed route and to
    the plain version), the multi-stream block plans with a bfloat16 W_hh
    (each direction its plain loop), a multi-stream call with W_hh of
    both dtypes on the lane plans, and the single-direction route
    (``lstm_sequence``, ``LSTM(bidirectional=False)`` and a BiLSTM layer
    the merged kernels refuse): each output of the float32-W path's shape
    and dtype. The dtype pairs JAX's models never form, which its ops
    take, run and match JAX's ops at the flip bars: a bfloat16 W_hh
    beside float32 x and W_ih in the fused op, bfloat16 multi-stream xp,
    a bfloat16 merged xp beside a float32 W_hh (lean), and a float32 xp
    beside a bfloat16 W_hh and bfloat16 residuals (under autograd, its
    gradients too)."""
    rng = np.random.RandomState(5)
    xp = _t(rng.randn(4, 2, 32).astype(np.float32))
    w = _t(rng.randn(32, 8).astype(np.float32)).to(BF16)
    want = lstm.lstm_sequence(xp, w.float(), False)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            got = lstm.lstm_sequence(xp, w.requires_grad_(grad), False)
        assert (got.shape, got.dtype) == (want.shape, F32)
        assert (got.grad_fn is not None) == grad
    x = _t(rng.randn(4, 2, 5).astype(np.float32))
    wi = _t(rng.randn(32, 5).astype(np.float32))
    b = _t(rng.randn(32).astype(np.float32))
    wd = w.detach()
    bf16_args = (x.to(BF16), wi.to(BF16), wi.to(BF16), b, b, wd, wd)
    got = bilstm.bilstm_sequence_fused(*bf16_args)
    want = bilstm.bilstm_sequence_fused_reference(*bf16_args)
    for g, r in zip(got, want):
        assert g.dtype == F32
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    # float32 x and W_ih beside a bfloat16 W_hh: JAX's fused op
    jw = jnp.asarray(_f32(wd).T).astype(jnp.bfloat16)
    jx, jwi, jb = (jnp.asarray(_f32(a)) for a in (x, wi.t(), b))
    for g, r in zip(bilstm.bilstm_sequence_fused(x, wi, wi, b, b, wd, wd),
                    pallas_lstm.bilstm_sequence_fused(jx, jwi, jwi, jb, jb,
                                                      jw, jw)):
        assert_flips_within(g, r, "fused, float32 x and W_ih")
    monkeypatch.setattr(bilstm, "PROJ_FUSION", "auto")
    assert bilstm.fused_proj_plan(4, 2, 8, 5, BF16)
    layer = tl.LSTM(5, 8, 1, torch.Generator(), dtype=BF16,
                    residual_dtype=F32)
    fused = layer(x.transpose(0, 1))  # the fused route runs it
    monkeypatch.setattr(bilstm, "PROJ_FUSION", "off")
    merged = layer(x.transpose(0, 1))  # the composed merged route runs it
    # float32 residuals: both routes multiply the same rounded operands
    _assert_layer_close(fused, merged, "fused vs composed")
    uni = tl.LSTM(5, 8, 1, torch.Generator(), dtype=BF16,
                  bidirectional=False)
    uni32 = tl.LSTM(5, 8, 1, torch.Generator(), bidirectional=False)
    uni32.load_state_dict(uni.state_dict())
    want = uni32(x.transpose(0, 1))
    got = uni(x.transpose(0, 1))
    assert (got.shape, got.dtype) == (want.shape, F32)
    # a batch the merged kernels refuse goes to the single route
    monkeypatch.setattr(bilstm, "merged_bidir_fits", lambda *a, **k: False)
    got = layer(x.transpose(0, 1))
    assert (got.shape, got.dtype) == (merged.shape, F32)
    wide = _t(rng.randn(4, 2, 4 * 33).astype(np.float32))
    w33 = _t(rng.randn(4 * 33, 33).astype(np.float32)).to(BF16)
    # a block-plan width at bfloat16 W: each direction its plain loop
    outs = multi_bilstm.multi_bilstm_sequence(1, wide, wide, w33, w33)
    for d, out in enumerate(outs):
        alone = bilstm.lstm_direction_forward_reference(wide, w33, bool(d))
        torch.testing.assert_close(out, alone[0], rtol=0, atol=0)
    # a bfloat16 multi-stream xp: JAX's multi-stream op
    jxp = jnp.asarray(_f32(xp)).astype(jnp.bfloat16)
    for g, r in zip(multi_bilstm.multi_bilstm_sequence(
            1, xp.to(BF16), xp.to(BF16), w.detach(), w.detach()),
            pallas_multilstm.multi_bilstm_sequence(1, None, jxp, jxp, jw,
                                                   jw)):
        assert_flips_within(g, r, "multi-stream, bfloat16 xp")
    w32 = w.detach().float()
    # a float32 W_hh of any width beside a bfloat16 one runs, each
    # direction as it runs alone
    mixed = multi_bilstm.multi_bilstm_sequence(1, xp, xp, w.detach(), w32)
    for d, (x, wd) in enumerate(((xp, w.detach()), (xp, w32))):
        alone = multi_bilstm.multi_bilstm_sequence(1, x, x, wd, wd)[d]
        torch.testing.assert_close(mixed[d], alone, rtol=0, atol=0)
    # a bfloat16 merged xp beside a float32 W_hh: JAX's merged op
    jw32 = jnp.asarray(_f32(w32).T)
    for g, r in zip(bilstm.bilstm_sequence(xp.to(BF16), xp.to(BF16), w32,
                                           w32),
                    pallas_lstm.bilstm_sequence(jxp, jxp, jw32, jw32)):
        assert_flips_within(g, r, "merged, bfloat16 xp")
    # a float32 xp beside a bfloat16 W_hh and bfloat16 residuals, under
    # autograd: JAX's merged op and its VJP
    jxp32 = jnp.asarray(_f32(xp))
    outs, vjp = jax.vjp(lambda a, b, c, d: pallas_lstm.bilstm_sequence(
        a, b, c, d, jnp.bfloat16), jxp32, jxp32, jw, jw)
    dh = rng.randn(*outs[0].shape).astype(np.float32)
    want = vjp((jnp.asarray(dh), jnp.asarray(dh)))
    leaves = [xp.clone().requires_grad_(True) for _ in "fb"] + [
        w.detach().clone().requires_grad_(True) for _ in "fb"]
    got_h = bilstm.bilstm_sequence(*leaves, BF16)
    got = torch.autograd.grad(got_h, leaves, [_t(dh)] * 2)
    for g, r in zip(got_h, outs):
        assert_flips_within(g, r, "merged, float32 xp, h")
    for k, (g, r) in enumerate(zip(got, want)):
        if k < 2:
            assert_flips_within(g, r, "dxp", ulps=2)
        else:
            assert_dw_close(g, _f32(r).T, "dw")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bilstm.check_compute(torch.float16, F32)
