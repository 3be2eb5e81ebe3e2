"""The multi-stream op at widths its lane plans do not hold (a direction
of 33-64: the kernels' block plans) at bfloat16: the port's plain
versions and ``MultiBiLSTMFunction`` (CPU) against ``pallas_multilstm``
in interpret mode (``TEST_FOLD``) at widths (8, 40, 1), a wide pitch
bottleneck beside the default content and rhythm ones, and (64, 3, 1),
the widest the kernels take. bfloat16 compute: W_hh bfloat16 on the
streams of H >= 2 and float32 on the H=1 one in the same call, xp, h and
dx float32; and the default config's float32 W_hh at bfloat16 residuals.
On the card the block plans are held to these plain versions
(chip_smoke.py's ``[kernel multi block ...]`` lines).

Bars, as tests/test_torch_compute_bf16.py states them (the flip bars of
a bfloat16-W recurrence) and tests/test_torch_residual_bf16.py (float32
W: h and dx 1e-5, g and c one bfloat16 ulp, dW_hh 2^-8 of its largest
magnitude); the dxp of a whole Function at float32 W takes the flip bar
too (each side's gradient reads its own forward's rounded residuals).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_multilstm
from speechsplit_tpu_torch.ops import multi_bilstm
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
from tests.test_torch_residual_bf16 import (
    B,
    H_TOL,
    T,
    _f32,
    _t,
    assert_within_one_ulp,
)

WIDTHS = pytest.mark.parametrize("widths", [(8, 40, 1), (64, 3, 1)],
                                 ids=lambda w: "-".join(map(str, w)))


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _block_inputs(widths, bf16_w: bool, seed: int = 0):
    """Both packages' inputs at ``widths`` (one stream each): xp float32,
    W_hh bfloat16 for H >= 2 where ``bf16_w`` (float32 for H = 1, as
    ``_recurrent_dtype`` gives it), else float32; cotangents float32."""
    rng = np.random.RandomState(1700 + 10 * sum(widths) + seed)
    xs, jws, tws, dhs = [], [], [], []
    for h in widths:
        for _ in range(2):
            xs.append(rng.randn(T, B, 4 * h).astype(np.float32))
            w = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
            if bf16_w and h >= 2:
                jw, tw = _bf16_w(w)
            else:
                jw, tw = jnp.asarray(w), _t(w.T)
            jws.append(jw)
            tws.append(tw)
            dhs.append(rng.randn(T, B, h).astype(np.float32))
    assert max(widths) > multi_bilstm.LANE_MAX_H  # a block-plan call
    assert multi_bilstm.fits(widths)
    return xs, jws, tws, dhs


@WIDTHS
@RESIDUALS
def test_block_forward_reference_matches_fwd_bf16_compute(widths, rd):
    xs, jws, tws, _ = _block_inputs(widths, True)
    assert {w.dtype for w in tws} == {BF16, F32}  # mixed in one call
    n, d2 = len(widths), 2 * len(widths)
    want = pallas_multilstm._fwd(n, _jdt(rd), *map(jnp.asarray, xs), *jws)
    got = multi_bilstm.multi_bilstm_forward_reference(
        n, *map(_t, xs), *tws, residual_dtype=_tdt(rd))
    for g, r in zip(got[:d2], want[:d2]):
        assert g.dtype == F32
        assert_flips_within(g, r, "h")
    for k, (g, r) in enumerate(zip(got[d2:], want[d2:])):
        assert g.dtype == _tdt(rd)
        assert_flips_within(g, r, f"{'gc'[k // d2]}{k % d2}")


@WIDTHS
def test_block_backward_reference_matches_bwd_call_bf16(widths):
    """The gradient at bfloat16 W and residuals on JAX's own residuals:
    dx float32 on both sides."""
    xs, jws, tws, dhs = _block_inputs(widths, True, seed=1)
    n, d2 = len(widths), 2 * len(widths)
    fwd = pallas_multilstm._fwd(n, jnp.bfloat16, *map(jnp.asarray, xs),
                                *jws)
    g, c = fwd[d2:2 * d2], fwd[2 * d2:]
    want = pallas_multilstm._bwd_call(n, *map(jnp.asarray, dhs), *g, *c, *c,
                                      *jws)
    got = multi_bilstm.multi_bilstm_backward_reference(
        n, *map(_t, dhs), *(_t(_f32(x)).to(BF16) for x in (*g, *c)), *tws)
    for d, (gx, r) in enumerate(zip(got, want)):
        assert gx.dtype == F32 and r.dtype == jnp.float32
        assert_flips_within(gx, r, f"dx{d}")


@WIDTHS
@pytest.mark.parametrize("w", ["bfloat16", "float32"])
def test_block_function_matches_jax_vjp(widths, w):
    """``MultiBiLSTMFunction`` at bfloat16 residuals (the default config),
    W_hh bfloat16 (bfloat16 compute, mixed with the H=1 stream's float32)
    or float32: h, the gradients of xp (float32) and of each W_hh (in its
    W's dtype) against JAX's custom VJP rules."""
    bf16_w = w == "bfloat16"
    xs, jws, tws, dhs = _block_inputs(widths, bf16_w, seed=2)
    n, d2 = len(widths), 2 * len(widths)
    outs, res = pallas_multilstm._vjp_fwd(n, jnp.bfloat16,
                                          *map(jnp.asarray, xs), *jws)
    want = pallas_multilstm._vjp_bwd(n, jnp.bfloat16, res,
                                     tuple(map(jnp.asarray, dhs)))
    inputs = [_t(x).requires_grad_(True) for x in xs] + [
        t.clone().requires_grad_(True) for t in tws]
    got_h = multi_bilstm.multi_bilstm_sequence(n, *inputs,
                                               residual_dtype=BF16)
    assert type(got_h[0].grad_fn).__name__ == "MultiBiLSTMFunctionBackward"
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dhs])
    for d in range(d2):
        assert got[d].dtype == F32
        assert got[d2 + d].dtype == tws[d].dtype
        assert want[d2 + d].dtype == jws[d].dtype
        assert_dw_close(got[d2 + d], _f32(want[d2 + d]).T, f"dw{d}")
    if bf16_w:
        for g, r in zip(got_h, outs):
            assert_flips_within(g, r, "h")
        for d in range(d2):
            assert_flips_within(got[d], want[d], f"dxp{d}")
    else:
        for g, r in zip(got_h, outs):
            np.testing.assert_allclose(_f32(g), _f32(r), atol=H_TOL)
        # each side's gradient reads its own forward's g and c, which may
        # round to neighbouring bfloat16 values: the flip bar (measured:
        # 17 of 20,480 elements of a direction past 1e-5, up to 3.2e-4)
        for d in range(d2):
            assert_flips_within(got[d], want[d], f"dxp{d}")
    assert not any(multi_bilstm.LAUNCHES.values())


@WIDTHS
def test_block_forward_reference_matches_fwd_bf16_residuals(widths):
    """float32 W_hh at bfloat16 residuals (the default config): h within
    1e-5, g and c within one bfloat16 ulp of ``_fwd``'s."""
    xs, jws, tws, _ = _block_inputs(widths, False, seed=3)
    n, d2 = len(widths), 2 * len(widths)
    want = pallas_multilstm._fwd(n, jnp.bfloat16, *map(jnp.asarray, xs),
                                 *jws)
    got = multi_bilstm.multi_bilstm_forward_reference(
        n, *map(_t, xs), *tws, residual_dtype=BF16)
    for g, r in zip(got[:d2], want[:d2]):
        np.testing.assert_allclose(_f32(g), _f32(r), atol=H_TOL)
    for k, (g, r) in enumerate(zip(got[d2:], want[d2:])):
        assert g.dtype == BF16 and r.dtype == jnp.bfloat16
        assert_within_one_ulp(g, r, f"{'gc'[k // d2]}{k % d2}")
