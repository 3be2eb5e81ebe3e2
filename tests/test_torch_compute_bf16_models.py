"""bfloat16 compute through whole models: both models' eval forward and
``convert_batched`` against the JAX package's at ``compute_dtype=
"bfloat16"`` (a tiny config, weights carried by interop).

The JAX side runs its Pallas kernels in interpret mode at B=8 (the fused
multi-stream path, as on the TPU). The inputs are what the models see:
mels in [0, 1) beside one-hot F0 contours. Two bars each:
- the distance (the mean absolute difference over the output) from
  JAX's bfloat16 result within ``0.25`` x JAX's own distance between its
  bfloat16 and float32 results on the same inputs and weights: the port
  rounds where JAX rounds, not merely stays near float32 (QUARTER).
  The mean, not the largest difference: a bfloat16 conv output, or an
  operand a recurrence rounds, whose two float32 sums (taken in another
  order) straddle a rounding boundary lands one bfloat16 ulp apart, and
  the layers after it carry that on; where it hits a large element one
  such ulp is as large as JAX's whole rounding there. Measured at the
  SpeechSplit forward (bfloat16 residuals): the mean 0.114 of JAX's, the
  largest difference 0.535 of JAX's; leaving out the port's rounding of
  h_{t-1}, of the xp streams or of the conv outputs moves the mean to
  0.66, 0.76 and 0.77 of JAX's;
- the largest difference within 2^-6 of the largest magnitude of JAX's
  bfloat16 result (ABS).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu import convert as jconvert
from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch import convert as tconvert
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from tests.test_torch_compute_bf16 import interpret
from tests.test_torch_convert import TINY, _pairs
from tests.test_torch_models import _jax_params, _port

B, T = 8, 32
QUARTER = 0.25
ABS = 2.0 ** -6


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _jdtype(name):
    return jnp.bfloat16 if name == "bfloat16" else jnp.float32


def assert_rounds_like_jax(got, want16, want32, what):
    """The two bars of the module docstring."""
    got, want16, want32 = (np.asarray(x, np.float32)
                           for x in (got, want16, want32))
    assert got.shape == want16.shape, what
    ours = float(np.abs(got - want16).mean())
    theirs = float(np.abs(want16 - want32).mean())
    assert theirs > 0, what  # bfloat16 compute moved JAX's result
    assert ours <= QUARTER * theirs, (what, ours, theirs)
    worst = float(np.abs(got - want16).max())
    assert worst <= ABS * float(np.abs(want16).max()), (what, worst)


def _onehot(rng, shape):
    return np.eye(257, dtype=np.float32)[rng.randint(0, 257, shape)]


def _jax_pair(monkeypatch, cls, residual, *inputs):
    """(JAX's bfloat16 result, its float32 one, the params) on the same
    inputs and weights. The float32 one runs JAX's scan path (no Pallas):
    at float32 compute the forward rounds nothing, so it is the Pallas
    path's result to float32 noise, in a fraction of the time."""
    out, params = {}, None
    for compute in ("float32", "bfloat16"):
        monkeypatch.setattr(pallas_lstm, "FORCE_INTERPRET",
                            compute == "bfloat16")
        jcfg = JaxConfig(**TINY, residual_dtype=residual,
                         compute_dtype=compute)
        model = cls(jcfg, dtype=_jdtype(compute))
        if params is None:
            params = _jax_params(model, *inputs)
        out[compute] = np.asarray(model.apply({"params": params}, *inputs))
    return out["bfloat16"], out["float32"], params


@pytest.mark.parametrize("residual", ["bfloat16", "float32"])
def test_speechsplit_forward_bf16(monkeypatch, residual):
    """The eval forward at bfloat16 compute: the merged layers' xp
    streams follow stream_dtype (bfloat16 beside bfloat16 residuals)."""
    cfg = SpeechSplitConfig(**TINY, residual_dtype=residual,
                            compute_dtype="bfloat16")
    rng = np.random.RandomState(14)
    x_org = rng.rand(B, T, cfg.dim_freq).astype(np.float32)
    x_f0 = np.concatenate([x_org, _onehot(rng, (B, T))], axis=-1)
    c_trg = np.eye(cfg.dim_spk_emb, dtype=np.float32)[:B]
    want16, want32, params = _jax_pair(monkeypatch, JaxSpeechSplit,
                                       residual, x_f0, x_org, c_trg)
    model = _port(SpeechSplit, cfg, params, "speechsplit")
    assert model.decoder.lstm.dtype == torch.bfloat16
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x_f0, x_org, c_trg)))
    assert got.dtype == torch.float32
    assert_rounds_like_jax(got, want16, want32, "mel")


def test_f0_converter_forward_bf16(monkeypatch):
    cfg = SpeechSplitConfig(**TINY, compute_dtype="bfloat16")
    rng = np.random.RandomState(15)
    x_org = rng.rand(B, T, cfg.dim_freq).astype(np.float32)
    f0_trg = _onehot(rng, (B, T))

    want16, want32, params = _jax_pair(monkeypatch, JaxF0Converter,
                                       "bfloat16", x_org, f0_trg)
    model = _port(F0Converter, cfg, params, "f0_converter")
    with torch.no_grad():
        got = model(torch.from_numpy(x_org), torch.from_numpy(f0_trg))
    assert_rounds_like_jax(got, want16, want32, "logits")


def test_convert_batched_bf16(monkeypatch):
    """``convert_batched`` (2 pairs x 7 conditions) against JAX's at
    bfloat16 compute. JAX takes its scan path at these batches, whose xp
    stays float32: so float32 residuals, where the port's streams are
    float32 too. The converted F0 contours equal JAX's; the bars hold
    over the call's 14 mels together (one mel's mean moves with a few
    flipped roundings: its worst reads 0.26 of JAX's distance)."""
    monkeypatch.setattr(pallas_lstm, "FORCE_INTERPRET", False)
    # the generator eagerly, as the forward tests run it: under jit XLA
    # may keep excess precision where the program rounds to bfloat16
    monkeypatch.setattr(jconvert, "_generate_jit",
                        jconvert._generate_jit.__wrapped__)
    jax_pairs, port_pairs = _pairs([(30, 25), (20, 32)], seed=4)
    x_f0 = np.zeros((1, T, 337), np.float32)
    x_org = np.zeros((1, T, 80), np.float32)
    results = {}
    params = None
    for compute in ("float32", "bfloat16"):
        jcfg = JaxConfig(**TINY, residual_dtype="float32",
                         compute_dtype=compute)
        dtype = _jdtype(compute)
        jg, jp = JaxSpeechSplit(jcfg, dtype=dtype), JaxF0Converter(
            jcfg, dtype=dtype)
        if params is None:
            params = (_jax_params(jg, x_f0, x_org, np.zeros((1, 82))),
                      _jax_params(jp, x_org, np.zeros((1, T, 257))))
        results[compute] = jconvert.convert_batched(
            jg, params[0], jp, params[1], jax_pairs)
    cfg = SpeechSplitConfig(**TINY, residual_dtype="float32",
                            compute_dtype="bfloat16")
    g = _port(SpeechSplit, cfg, params[0], "speechsplit")
    p = _port(F0Converter, cfg, params[1], "f0_converter")
    # the converted F0 contours (argmax of the logits) equal JAX's
    jp = JaxF0Converter(JaxConfig(**TINY, residual_dtype="float32",
                                  compute_dtype="bfloat16"),
                        dtype=jnp.bfloat16)
    want_f0 = jconvert._f0_convert_jit(
        jp, params[1], jnp.concatenate([s.mel for s, _ in jax_pairs]),
        jnp.concatenate([t.f0_onehot for _, t in jax_pairs]))
    got_f0 = tconvert._f0_onehot(
        p, torch.cat([s.mel for s, _ in port_pairs]),
        torch.cat([t.f0_onehot for _, t in port_pairs]))
    np.testing.assert_array_equal(got_f0.numpy(), np.asarray(want_f0))
    got = tconvert.convert_batched(g, p, port_pairs)
    mels = {k: [] for k in ("got", "bfloat16", "float32")}
    for pair, want16, want32 in zip(got, results["bfloat16"],
                                    results["float32"]):
        for (name, mel), (_, w16), (_, w32) in zip(pair, want16, want32):
            assert np.isfinite(mel).all() and mel.shape == w16.shape, name
            for k, v in (("got", mel), ("bfloat16", w16), ("float32", w32)):
                mels[k].append(np.asarray(v).ravel())
    assert_rounds_like_jax(*(np.concatenate(mels[k]) for k in mels), "grid")
