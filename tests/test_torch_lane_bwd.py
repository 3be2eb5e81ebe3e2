"""The lane step of the narrow gradient kernels (``csrc/lane_bwd.cuh``,
run by ``multi_bilstm_bwd`` for widths up to 32 and by ``lstm_bwd``'s
narrow plan) takes its float32 operations in another order than the plain
version: the gate factors a step ahead (``a = o (1 - tanh_c^2)``,
``p_i = g i (1 - i)``, ...), ``dc`` by one fused multiply-add, and
``dh_carry`` as four chains of FMAs, one a gate, added pairwise. A CUDA
kernel does not run here, so that order is emulated in numpy and held to
both JAX gradient kernels (``pallas_lstm._bwd_call``,
``pallas_multilstm._bwd_call``) in interpret mode; the sources' plan
borders are read against each other."""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from speechsplit_tpu.ops import pallas_lstm, pallas_multilstm
from speechsplit_tpu_torch.ops import _build
from tests.jax_interpret import interpret
from tests.test_torch_multi_bilstm import PLAN_CASES, plan_case_id, plan_inputs

T = 12
B = 8  # pallas_lstm.supported() takes the Pallas path from B = 8
TOL = 1e-5
LANE_CASES = [case for case in PLAN_CASES if max(case[2]) <= 32]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)
    monkeypatch.setattr(pallas_lstm, "RESIDUAL_DTYPE", jnp.float32)


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float64 product of two float32
    values is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def lane_step_emulation(dh, g, c, w, reverse):
    """The lane step's arithmetic in its order, float32 numpy: dh, c
    [T, B, H], g [T, B, 4H], w [4H, H] (torch's layout); returns dx."""
    t_len, batch, hidden = dh.shape
    one = np.float32(1.0)
    dh_carry = np.zeros((batch, hidden), np.float32)
    dc_carry = np.zeros_like(dh_carry)
    dx = np.empty_like(g)
    for t in range(t_len) if reverse else range(t_len - 1, -1, -1):
        tc = t + 1 if reverse else t - 1
        c_prev = c[tc] if 0 <= tc < t_len else np.zeros_like(dh_carry)
        i, f, gg, o = np.split(g[t], 4, axis=-1)
        tanh_c = np.tanh(c[t])
        a = o * (one - tanh_c * tanh_c)
        p_i = (gg * i) * (one - i)
        p_f = (c_prev * f) * (one - f)
        p_g = i * (one - gg * gg)
        p_o = (tanh_c * o) * (one - o)
        d = dh[t] + dh_carry
        dc = _fma(d, a, dc_carry)
        dp = [dc * p_i, dc * p_f, dc * p_g, d * p_o]
        dc_carry = dc * f
        dx[t] = np.concatenate(dp, axis=-1)
        # lane k: acc_q = sum over units u, in order, of dp_q[u] W[qH+u][k]
        acc = [np.zeros_like(dh_carry) for _ in range(4)]
        for u in range(hidden):
            for q in range(4):
                acc[q] = _fma(dp[q][:, u:u + 1], w[q * hidden + u][None, :],
                              acc[q])
        dh_carry = (acc[0] + acc[1]) + (acc[2] + acc[3])
    return dx


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h", [1, 5, 8, 31, 32])
def test_lane_order_matches_pallas_bwd_call(h, reverse):
    rng = np.random.RandomState(100 * h + reverse)
    xp = rng.randn(T, B, 4 * h).astype(np.float32)
    w = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)  # JAX layout
    dh = rng.randn(T, B, h).astype(np.float32)
    _, g, c = pallas_lstm._fwd(jnp.asarray(xp), jnp.asarray(w),
                               residual_dtype=jnp.float32, reverse=reverse)
    want = pallas_lstm._bwd_call(jnp.asarray(dh), g, c, jnp.asarray(w),
                                 reverse=reverse)
    got = lane_step_emulation(dh, np.asarray(g), np.asarray(c),
                              np.ascontiguousarray(w.T), reverse)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)


@pytest.mark.parametrize("case", LANE_CASES, ids=plan_case_id)
def test_lane_order_matches_multi_bwd_call(case):
    t, b, hs = case
    xs, ws = plan_inputs(t, b, hs)
    n, d2 = len(hs), 2 * len(hs)
    rng = np.random.RandomState(7 * t + b)
    dhs = [rng.randn(t, b, h).astype(np.float32) for h in hs for _ in (0, 1)]
    fwd = pallas_multilstm._fwd(n, jnp.float32, *map(jnp.asarray, xs + ws))
    g, c = fwd[d2:2 * d2], fwd[2 * d2:]
    want = pallas_multilstm._bwd_call(n, *map(jnp.asarray, dhs), *g, *c, *c,
                                      *map(jnp.asarray, ws))
    for d in range(d2):
        got = lane_step_emulation(dhs[d], np.asarray(g[d]), np.asarray(c[d]),
                                  np.ascontiguousarray(ws[d].T), d % 2 == 1)
        np.testing.assert_allclose(got, np.asarray(want[d]), atol=TOL)


def test_plan_borders_agree():
    """The gradient's lane step (``lane_bwd.cuh``) takes the widths the
    forwards' lane and narrow plans take, so a layer's forward and
    backward split at the same width."""
    text = (_build.CSRC / "lane_bwd.cuh").read_text()
    lane = int(re.search(r"^constexpr int kLaneMaxH = (\d+);", text,
                         re.M)[1])
    assert lane == 32
    assert _build.source_constant("multi_bilstm_infer", "kLaneMaxH") == lane
    assert _build.source_constant("lstm_infer", "kNarrowMaxH") == lane


@pytest.mark.parametrize("stem", ["multi_bilstm_bwd", "lstm_bwd"])
def test_gradient_sources_share_the_lane_step(stem):
    names = [p.name for p in _build._headers(_build.CSRC / f"{stem}.cu")]
    assert names[0] == "lane_bwd.cuh"
    assert all((_build.CSRC / name).exists() for name in names)
