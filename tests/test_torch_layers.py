"""Each layer of the port against the JAX layer, same weights and inputs
(f32, CPU; the tests/test_layers.py bar of 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.models import layers as jl
from speechsplit_tpu_torch.models import layers as tl

ATOL = 2e-5


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got: torch.Tensor, want, atol=ATOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol)


def test_linear(rng):
    x = rng.randn(3, 7, 16).astype(np.float32)
    params = jl.Linear(24).init(jax.random.PRNGKey(0), x)["params"]
    layer = tl.Linear(16, 24, _gen())
    layer.load_state_dict({
        "linear_layer.weight": _t(params["kernel"]).T,
        "linear_layer.bias": _t(params["bias"]),
    })
    _close(layer(_t(x)), jl.Linear(24).apply({"params": params}, x))


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv1d_same_padding(rng, dilation):
    x = rng.randn(2, 31, 12).astype(np.float32)
    mod = jl.Conv1d(20, kernel_size=5, dilation=dilation, w_init_gain="relu")
    params = mod.init(jax.random.PRNGKey(1), x)["params"]
    layer = tl.Conv1d(12, 20, _gen(), kernel_size=5, dilation=dilation)
    layer.load_state_dict({
        "conv.weight": _t(params["kernel"]).permute(2, 1, 0),
        "conv.bias": _t(params["bias"]),
    })
    _close(layer(_t(x)), mod.apply({"params": params}, x))


def test_groupnorm(rng):
    x = (rng.randn(2, 19, 32) * 3 + 1).astype(np.float32)
    mod = jl.GroupNorm(num_groups=4)
    params = {"scale": rng.rand(32).astype(np.float32),
              "bias": rng.randn(32).astype(np.float32)}
    layer = tl.GroupNorm(4, 32)
    layer.load_state_dict({"weight": _t(params["scale"]),
                           "bias": _t(params["bias"])})
    _close(layer(_t(x)), mod.apply({"params": params}, x))


def _lstm_pair(rng, in_features, hidden, layers):
    x = rng.randn(3, 24, in_features).astype(np.float32)
    mod = jl.LSTM(hidden, num_layers=layers, bidirectional=True)
    params = mod.init(jax.random.PRNGKey(2), x)["params"]
    ours = tl.LSTM(in_features, hidden, layers, _gen(),
                   residual_dtype=torch.float32)
    state = {}
    for name, value in params.items():
        kind, side, sfx = name.split("_", 2)
        key = f"{'weight' if kind == 'w' else 'bias'}_{side}_{sfx}"
        state[key] = _t(value).T if kind == "w" else _t(value)
    ours.load_state_dict(state)
    return x, mod, params, ours


@pytest.mark.parametrize("hidden,layers", [(1, 1), (8, 2), (32, 1)])
def test_lstm_run_mode(rng, hidden, layers):
    x, mod, params, ours = _lstm_pair(rng, 12, hidden, layers)
    _close(ours(_t(x)), mod.apply({"params": params}, x))


def test_lstm_streams_and_start_layer(rng):
    x, mod, params, ours = _lstm_pair(rng, 12, 8, 2)
    want = mod.apply({"params": params}, x, mode="streams", start_layer=0)
    got = ours(_t(x), mode="streams", start_layer=0)
    # projected streams match; the port's weights are the transpose
    _close(got[0], want[0])
    _close(got[1], want[1])
    _close(got[2].T, want[2], atol=0)
    _close(got[3].T, want[3], atol=0)
    h = rng.randn(3, 24, 16).astype(np.float32)
    _close(ours(_t(h), start_layer=1),
           mod.apply({"params": params}, h, start_layer=1))


def test_recurrent_dtype():
    assert tl._recurrent_dtype(torch.bfloat16, 1) is torch.float32
    assert tl._recurrent_dtype(torch.bfloat16, 8) is torch.bfloat16
    assert tl._recurrent_dtype(torch.float32, 1) is torch.float32
    assert jl._recurrent_dtype(jnp.bfloat16, 1) == jnp.float32


@pytest.mark.parametrize("t", [32, 16])
def test_code_sampling(rng, t):
    out = rng.randn(2, t, 16).astype(np.float32)
    _close(tl.downsample_codes(_t(out), 8, 8),
           jl.downsample_codes(jnp.asarray(out), 8, 8), atol=0)
    codes = rng.randn(2, 4, 6).astype(np.float32)
    _close(tl.upsample_codes(_t(codes), 8),
           jl.upsample_codes(jnp.asarray(codes), 8), atol=0)
    h_f, h_b = (rng.randn(t, 2, 5).astype(np.float32) for _ in "fb")
    _close(tl.combine_bidir(_t(h_f), _t(h_b)),
           jl.combine_bidir(jnp.asarray(h_f), jnp.asarray(h_b)), atol=0)
