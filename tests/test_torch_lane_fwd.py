"""The residual-saving forward's two plans (``lstm_fwd`` in
``csrc/lstm_infer.cu``) take their float32 operations in another order
than the plain version's matmul. The narrow plan (H <= 32: the lane step
of ``csrc/lane_fwd.cuh``, which the multi-stream forwards share) sums
each gate's product in one FMA chain over ascending k, zero-padded to the
row's L lanes. The wide plan (H > 32: the merged forward's step for one
direction) gives lane l of a unit's warp the k = 128 q + 4 l + kk, one
FMA chain over ascending q and kk, and adds the 32 lanes' partial sums by
the round's butterfly (lanes 16 apart, then 8, 4, 2, 1). Both round the
cell update's products and sum on their own. A CUDA kernel does not run
here, so each order is emulated in numpy and held to the JAX kernel
``pallas_lstm._fwd`` in interpret mode (float32 residuals); the sources'
plan borders are read against each other."""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.ops import _build
from tests.jax_interpret import interpret

T = 12
B = 8  # pallas_lstm.supported() takes the Pallas path from B = 8
TOL = 1e-5
ONE = np.float32(1.0)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)
    monkeypatch.setattr(pallas_lstm, "RESIDUAL_DTYPE", jnp.float32)


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float64 product of two float32
    values is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def narrow_products(h_prev, w):
    """h_{t-1} W_hh^T [B, 4H] as the lane step sums it: lane u's four
    chains over k = 0 .. L-1 (L the least power of two >= H), the terms
    past H exact zeros."""
    batch, hidden = h_prev.shape
    lanes = 1 << (hidden - 1).bit_length()
    acc = np.zeros((batch, 4 * hidden), np.float32)
    for k in range(lanes):
        hk = h_prev[:, k:k + 1] if k < hidden else np.zeros((batch, 1),
                                                            np.float32)
        wk = w[:, k] if k < hidden else np.zeros(4 * hidden, np.float32)
        acc = _fma(hk, wk[None, :], acc)
    return acc


def wide_products(h_prev, w):
    """h_{t-1} W_hh^T [B, 4H] as the wide plan sums it: lane l's chain over
    k = 128 q + 4 l + kk (q, then kk, ascending; k < H), then the
    butterfly's pairwise adds over lanes 16, 8, 4, 2 and 1 apart."""
    batch, hidden = h_prev.shape
    passes = -(-hidden // 128)
    partial = np.zeros((32, batch, 4 * hidden), np.float32)
    for lane in range(32):
        for q in range(passes):
            for kk in range(4):
                k = 128 * q + 4 * lane + kk
                if k < hidden:
                    partial[lane] = _fma(h_prev[:, k:k + 1], w[:, k][None, :],
                                         partial[lane])
    for off in (16, 8, 4, 2, 1):
        partial = partial + partial[np.arange(32) ^ off]
    return partial[0]


def plan_emulation(xp, w, reverse, products):
    """``lstm_fwd``'s arithmetic in a plan's order, float32 numpy: xp
    [T, B, 4H], w [4H, H] (torch's layout); returns h, g, c."""
    t_len, batch, four_h = xp.shape
    hidden = four_h // 4
    h = np.zeros((batch, hidden), np.float32)
    c = np.zeros_like(h)
    hs, gs, cs = (np.empty((t_len, batch, n), np.float32)
                  for n in (hidden, four_h, hidden))
    for t in range(t_len - 1, -1, -1) if reverse else range(t_len):
        i, f, g, o = np.split(xp[t] + products(h, w), 4, axis=-1)
        i, f, o = (ONE / (ONE + np.exp(-z)) for z in (i, f, o))
        g = np.tanh(g)
        c = f * c + i * g  # each product and the sum rounded on its own
        h = o * np.tanh(c)
        hs[t], gs[t], cs[t] = h, np.concatenate([i, f, g, o], -1), c
    return hs, gs, cs


def _check_plan(h, reverse, products):
    rng = np.random.RandomState(100 * h + reverse)
    xp = rng.randn(T, B, 4 * h).astype(np.float32)
    w = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)  # JAX layout
    want = pallas_lstm._fwd(jnp.asarray(xp), jnp.asarray(w),
                            residual_dtype=jnp.float32, reverse=reverse)
    got = plan_emulation(xp, np.ascontiguousarray(w.T), reverse, products)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), atol=TOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h", [1, 5, 8, 31, 32])
def test_narrow_order_matches_pallas_fwd(h, reverse):
    _check_plan(h, reverse, narrow_products)


@pytest.mark.parametrize("reverse", [False, True])
# one pass of 128 (33, 64) and a second, partial one (130)
@pytest.mark.parametrize("h", [33, 64, 130])
def test_wide_order_matches_pallas_fwd(h, reverse):
    _check_plan(h, reverse, wide_products)


def _header_constant(name, constant):
    text = (_build.CSRC / name).read_text()
    return int(re.search(rf"^constexpr int {constant} = (\d+);", text,
                         re.M)[1])


def test_plan_borders_agree():
    """``lstm_fwd``'s narrow plan takes the widths of ``lstm_infer``'s
    narrow plan and of the gradient's lane step, so a layer's forward,
    lean forward and gradient split at one width."""
    border = _header_constant("lane_fwd.cuh", "kLaneMaxH")
    assert border == 32
    assert _build.source_constant("lstm_infer", "kNarrowMaxH") == border
    assert _header_constant("lane_bwd.cuh", "kLaneMaxH") == border
    assert _build.source_constant("multi_bilstm_infer", "kLaneMaxH") == border


@pytest.mark.parametrize("stem", ["multi_bilstm_infer", "lstm_infer"])
def test_forward_sources_share_the_lane_step(stem):
    names = [p.name for p in _build._headers(_build.CSRC / f"{stem}.cu")]
    assert "lane_fwd.cuh" in names
    assert all((_build.CSRC / name).exists() for name in names)
