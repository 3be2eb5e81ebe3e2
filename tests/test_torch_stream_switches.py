"""JAX's four stream switches (pallas_lstm.py:86-210) in the port
(``ops.bilstm``): each flipped in both packages, the dtype rules the
port's helpers give against JAX's, and a 2-layer ``LSTM`` layer's output
and parameter gradients against JAX's layer at the precision where the
switch acts. JAX reads the switches where it traces a call, so its
layers here are applied op by op, with no outer ``jax.jit``.

Bars (those of tests/test_torch_fused_bf16.py's layer test): the output
within 1e-5 at float32 compute, within the flip bars of
tests/test_torch_compute_bf16.py at bfloat16 compute; every parameter's
gradient within 2^-8 of its largest magnitude plus one bfloat16 ulp of
the element (the residuals round). The h switch writes h rounded and
keeps the carry float32, so its bfloat16 h is the float32 h rounded, bit
for bit (tests/test_pallas_lstm.py:249-270 asserts the same of JAX's).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.models import layers as jl
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.models import layers as tl
from speechsplit_tpu_torch.ops import bilstm, lstm
from tests.jax_interpret import interpret
from tests.test_torch_compute_bf16 import assert_dw_close, assert_flips_within
from tests.test_torch_residual_bf16 import H_TOL, _f32, _t

SWITCHES = ("GRAD_STREAM_FOLLOWS_RESIDUAL", "XP_STREAM_FOLLOWS_COMPUTE",
            "DH_STREAM_FOLLOWS_RESIDUAL", "H_STREAM_FOLLOWS_COMPUTE")
# the compute dtype at which each switch acts on a layer (all at
# bfloat16 residuals, the default)
ACTS_AT = {"GRAD_STREAM_FOLLOWS_RESIDUAL": "float32",
           "DH_STREAM_FOLLOWS_RESIDUAL": "float32",
           "XP_STREAM_FOLLOWS_COMPUTE": "bfloat16",
           "H_STREAM_FOLLOWS_COMPUTE": "bfloat16"}
B, T, I, H = 8, 6, 5, 8
BF16 = torch.bfloat16
F32 = torch.float32
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, None: None}
_T = {"float32": F32, "bfloat16": BF16, None: None}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def flip(monkeypatch, name: str, value: bool) -> None:
    """Switch ``name`` set to ``value`` in both packages."""
    monkeypatch.setattr(pallas_lstm, name, value)
    monkeypatch.setattr(bilstm, name, value)


@pytest.mark.parametrize("name,value", [
    (name, value) for name in SWITCHES for value in (False, True)])
def test_dtype_rules_follow_jax(monkeypatch, name, value):
    """Every rule at every compute and residual dtype (None too), as JAX's
    (tests/test_pallas_lstm.py:160-176, :228-245 flip the same)."""
    flip(monkeypatch, name, value)
    for cd, rd in itertools.product(("float32", "bfloat16"),
                                    ("float32", "bfloat16", None)):
        pairs = (
            (bilstm.stream_dtype(_T[cd], _T[rd]),
             pallas_lstm.stream_dtype(_J[cd], _J[rd])),
            (bilstm._grad_stream_dtype(_T[rd]),
             pallas_lstm._grad_stream_dtype(_J[rd])),
            (bilstm._dh_stream_dtype(_T[cd], _T[rd]),
             pallas_lstm._dh_stream_dtype(_J[cd], _J[rd])),
            (bilstm._h_stream_dtype(_T[cd], _T[rd]),
             pallas_lstm._h_stream_dtype(_J[cd], _J[rd])))
        for ours, theirs in pairs:
            assert str(ours).removeprefix("torch.") == jnp.dtype(
                theirs).name, (cd, rd, ours, theirs)


def lstm_pair(rng, cd, rd, layers=2):
    """x [B, T, I], JAX's LSTM layer and its params, and the port's layer
    loaded from them, both at compute ``cd`` and residuals ``rd``."""
    x = rng.randn(B, T, I).astype(np.float32)
    mod = jl.LSTM(H, num_layers=layers, bidirectional=True, dtype=_J[cd],
                  residual_dtype=_J[rd])
    params = mod.init(jax.random.PRNGKey(7), x)["params"]
    ours = tl.LSTM(I, H, layers, torch.Generator(), dtype=_T[cd],
                   residual_dtype=_T[rd])
    state = {}
    for name, value in params.items():
        kind, side, sfx = name.split("_", 2)
        key = f"{'weight' if kind == 'w' else 'bias'}_{side}_{sfx}"
        state[key] = _t(value).T if kind == "w" else _t(value)
    ours.load_state_dict(state)
    return x, mod, params, ours


def layer_grads(rng, x, mod, params, ours):
    """JAX's and the port's output and parameter gradients of a mean
    square loss (the port's gradients keyed by JAX's names)."""
    target = rng.randn(B, T, 2 * H).astype(np.float32)

    def jax_loss(p):
        out = mod.apply({"params": p}, x)
        return jnp.mean(jnp.square(out.astype(jnp.float32) - target))

    want_out = mod.apply({"params": params}, x)
    want = jax.grad(jax_loss)(params)
    ours.zero_grad()
    out = ours(_t(x))
    torch.mean(torch.square(out.float() - _t(target))).backward()
    got = {}
    for name in want:
        kind, side, sfx = name.split("_", 2)
        key = f"{'weight' if kind == 'w' else 'bias'}_{side}_{sfx}"
        g = getattr(ours, key).grad
        got[name] = g.t() if kind == "w" else g
    return want_out, want, out.detach(), got


@pytest.mark.parametrize("name", SWITCHES)
def test_flipped_switch_layer_matches_jax(monkeypatch, name):
    """The switch away from its default, at the precision where it acts:
    the layer's output (its dtype too) and gradients against JAX's."""
    flip(monkeypatch, name, not getattr(pallas_lstm, name))
    rng = np.random.RandomState(21)
    cd = ACTS_AT[name]
    x, mod, params, ours = lstm_pair(rng, cd, "bfloat16")
    want_out, want, out, got = layer_grads(rng, x, mod, params, ours)
    assert str(out.dtype).removeprefix("torch.") == jnp.dtype(
        want_out.dtype).name
    if cd == "bfloat16":
        assert_flips_within(out, want_out, "out")
    else:
        np.testing.assert_allclose(_f32(out), _f32(want_out), atol=H_TOL)
    for key, value in want.items():
        assert_dw_close(got[key], value, key)
    assert not any(bilstm.LAUNCHES.values())


def test_h_switch_rounds_only_the_stored_h(monkeypatch):
    """At bfloat16 W and residuals, each op's h with the h switch on is its
    h with the switch off rounded to bfloat16, bit for bit, lean and under
    autograd."""
    rng = np.random.RandomState(22)
    xp = [_t(rng.randn(T, B, 4 * H).astype(np.float32)).to(BF16)
          for _ in "fb"]
    w = [_t((rng.randn(4 * H, H) / 3).astype(np.float32)).to(BF16)
         for _ in "fb"]
    x = _t(rng.randn(T, B, I).astype(np.float32)).to(BF16)
    wi = [_t(rng.randn(4 * H, I).astype(np.float32)).to(BF16) for _ in "fb"]
    b = [_t(rng.randn(4 * H).astype(np.float32)) for _ in "fb"]
    calls = {
        "merged": lambda: bilstm.bilstm_sequence(*xp, *w, BF16),
        "single": lambda: (lstm.lstm_sequence(xp[0], w[0], True, BF16),),
        "fused": lambda: bilstm.bilstm_sequence_fused(x, *wi, *b, *w, BF16),
        "layer": lambda: bilstm.bilstm_layer(x, *wi, *b, *w, BF16),
    }
    for what, call in calls.items():
        for grad in (False, True):
            for t in (*xp, *w, x, *wi, *b):
                t.requires_grad_(grad)
            flip(monkeypatch, "H_STREAM_FOLLOWS_COMPUTE", False)
            off = call()
            flip(monkeypatch, "H_STREAM_FOLLOWS_COMPUTE", True)
            on = call()
            for a, c in zip(on, off):
                assert a.dtype == BF16 and c.dtype == F32, what
                assert torch.equal(a, c.to(BF16)), (what, grad)
                assert (a.grad_fn is not None) == grad, what
