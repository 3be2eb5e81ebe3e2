"""The pitch tracker's options (``ops/pitch.py``) against the JAX
package's: the top K by argmax passes (``topk_by_sort=False``), the
grouped-convolution NCCF (``nccf_by_conv=True``), the parallel decoder
(``parallel_viterbi``) and the block decoder (``block_viterbi > 1``),
each alone and through ``track_pitch``.

The port's parallel decoder scans in ``jax.lax.associative_scan``'s
association order and its block decoder composes as JAX's does, so their
min-plus sums round alike and the states equal JAX's bit for bit: the
tests hold them to that, stricter than JAX's own 1% tie-flip allowance
between its decoders (tests/test_pitch.py:133-193). These decoders are
stock tensor ops on either device; the serial decoder's kernel is held to
its plain loop on the card by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pitch as jpitch
from speechsplit_tpu_torch.ops import pitch
from tests.speech_stimuli import default_utterance

HOP, WINDOW, KMIN, KMAX = 256, 120, 16000 // 600, 16000 // 50
SPAN = WINDOW + KMAX
DECODERS = ["parallel", 2, 4, 7, 16]  # the parallel one, then radices


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a call; one thread keeps them from contending with
    the other test processes for the cores. It changes no value."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_decoder(parallel: bool):
    return jax.jit(jpitch._viterbi_parallel if parallel
                   else jpitch._viterbi_block, static_argnums=(2, 3))


def _params(decoder):
    """(JAX's, the port's) PitchParams of a DECODERS entry."""
    fields = (dict(parallel_viterbi=True) if decoder == "parallel"
              else dict(block_viterbi=decoder))
    return jpitch.PitchParams(**fields), pitch.PitchParams(**fields)


def _random_field(t, seed=3):
    """JAX's test fields (tests/test_pitch.py:144-149)."""
    rng = np.random.RandomState(seed + t)
    lag = rng.uniform(26.0, 320.0, size=(t, 12)).astype(np.float32)
    score = rng.uniform(-0.2, 1.0, size=(t, 12)).astype(np.float32)
    return lag, score


def _tie_field(t, kind):
    """Scores on eighths and whole lags (path costs tie), every candidate
    unusable, or every candidate equal."""
    rng = np.random.RandomState(t)
    lag = np.floor(rng.uniform(26.0, 321.0, (t, 12))).astype(np.float32)
    score = (np.floor(rng.uniform(-1.6, 8.0, (t, 12))) / 8.0).astype(
        np.float32)
    if kind == "unusable":
        score = np.minimum(score, 0.3)
    elif kind == "equal":
        lag[:] = 100.0
        score[:] = 0.875
    return lag, score


def _decode_both(lag, score, decoder):
    jparams, params = _params(decoder)
    best_j, voiced_j = _jax_decoder(decoder == "parallel")(
        jnp.asarray(lag), jnp.asarray(score), KMAX, jparams)
    best_t, voiced_t = pitch._viterbi(torch.from_numpy(lag)[None],
                                      torch.from_numpy(score)[None], KMAX,
                                      params)
    return (best_t[0].numpy(), voiced_t[0].numpy(), np.asarray(best_j),
            np.asarray(voiced_j))


@pytest.mark.parametrize("decoder", DECODERS)
@pytest.mark.parametrize("t", [1, 2, 3, 5, 8, 9, 50, 251])
def test_decoder_equals_jax_on_random_fields(t, decoder):
    best_t, voiced_t, best_j, voiced_j = _decode_both(*_random_field(t),
                                                      decoder)
    np.testing.assert_array_equal(voiced_t, voiced_j)
    np.testing.assert_array_equal(best_t, best_j)


@pytest.mark.parametrize("decoder", ["parallel", 4])
@pytest.mark.parametrize("kind", ["ties", "unusable", "equal"])
def test_decoder_equals_jax_on_ties(kind, decoder):
    best_t, voiced_t, best_j, voiced_j = _decode_both(*_tie_field(33, kind),
                                                      decoder)
    np.testing.assert_array_equal(voiced_t, voiced_j)
    np.testing.assert_array_equal(best_t, best_j)


@pytest.mark.parametrize("decoder", DECODERS)
def test_decoders_batch_independent(decoder):
    """A batch decodes as its rows do alone, and every decoder agrees
    with the serial one on these fields."""
    fields = [_random_field(50, seed) for seed in (1, 2, 3)]
    lag = torch.from_numpy(np.stack([f[0] for f in fields]))
    score = torch.from_numpy(np.stack([f[1] for f in fields]))
    params = _params(decoder)[1]
    both = pitch._viterbi(lag, score, KMAX, params)
    serial = pitch._viterbi(lag, score, KMAX, pitch.PitchParams())
    for i in range(3):
        one = pitch._viterbi(lag[i : i + 1], score[i : i + 1], KMAX, params)
        for b, o in zip(both, one):
            np.testing.assert_array_equal(b[i : i + 1].numpy(), o.numpy())
    for b, s in zip(both, serial):
        np.testing.assert_array_equal(b.numpy(), s.numpy())
    assert not pitch.LAUNCHES["viterbi_decode"]


def test_top_k_by_max_equals_lax_top_k():
    """JAX's field (tests/test_pitch.py:113-129) with a batch dim: values
    and indices bit for bit, ties (the -2.0 plateau, a row of no peak)
    toward the lower index."""
    rng = np.random.RandomState(7)
    x = rng.rand(2, 64, 295).astype(np.float32)
    x[x < 0.6] = -2.0
    x[0, 5] = -2.0
    vals, idx = pitch._top_k_by_max(torch.from_numpy(x), 12)
    for b in range(2):
        ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x[b]), 12)
        j_vals, j_idx = jpitch._top_k_by_max(jnp.asarray(x[b]), 12)
        for want_vals, want_idx in ((ref_vals, ref_idx), (j_vals, j_idx)):
            np.testing.assert_array_equal(vals[b].numpy(), want_vals)
            np.testing.assert_array_equal(idx[b].numpy(), want_idx)


def test_nccf_by_conv_equals_jax_conv():
    """Every frame whose lagged windows lie inside the signal, within
    1e-5 of JAX's conv form (as tests/test_torch_pitch.py::test_nccf holds
    the FFT form); past the signal's end the value is the correlation's
    rounding times 1e6 in either package. The port's conv and FFT forms,
    both float64, within 1e-6 of each other over every frame."""
    x = default_utterance(3, 120.0).wav[:32768].astype(np.float32)
    n_frames = (len(x) - SPAN) // HOP + 1
    want = np.asarray(jpitch._nccf(jnp.asarray(x), n_frames, HOP, WINDOW,
                                   KMIN, KMAX, by_conv=True))
    xt = torch.from_numpy(x)[None]
    got = pitch._nccf(xt, n_frames, HOP, WINDOW, KMIN, KMAX,
                      by_conv=True)[0].numpy()
    assert got.shape == want.shape == (n_frames, KMAX - KMIN + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    padded = torch.nn.functional.pad(xt, (0, 40 * HOP))
    conv = pitch._nccf(padded, n_frames + 40, HOP, WINDOW, KMIN, KMAX,
                       by_conv=True)
    fft = pitch._nccf(padded, n_frames + 40, HOP, WINDOW, KMIN, KMAX)
    np.testing.assert_allclose(conv.numpy(), fft.numpy(), rtol=0, atol=1e-6)


def _utterances():
    x = np.zeros((2, 32768), np.float32)
    x[0] = default_utterance(3, 120.0).wav[:32768]
    x[1, :30000] = default_utterance(5, 220.0).wav[:30000]
    return x, np.array([32768, 30000], np.int32)


@pytest.mark.parametrize("gender_range", [(50.0, 250.0), (100.0, 600.0)])
@pytest.mark.parametrize("option", [
    dict(parallel_viterbi=True), dict(block_viterbi=4),
    dict(block_viterbi=16), dict(topk_by_sort=False),
    dict(nccf_by_conv=True)])
def test_track_pitch_option_equals_jax(option, gender_range):
    """End to end at tests/test_torch_pitch.py:139-144's bar: voicing,
    and log-F0 within 1e-5, on at least 99.5% of the frames."""
    x, lengths = _utterances()
    lo, hi = (np.full(2, v, np.float32) for v in gender_range)
    want = np.asarray(jpitch.track_pitch(
        jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(lo),
        jnp.asarray(hi), params=jpitch.PitchParams(**option)))
    got = pitch.track_pitch(
        torch.from_numpy(x), torch.from_numpy(lengths), torch.from_numpy(lo),
        torch.from_numpy(hi), params=pitch.PitchParams(**option)).numpy()
    assert got.shape == want.shape == (2, 129)
    voiced_j, voiced_t = want > -1e9, got > -1e9
    same = (voiced_j == voiced_t) & (~voiced_j | (np.abs(got - want) <= 1e-5))
    assert same.mean() > 0.995, same.mean()
    assert voiced_j.mean() > 0.2
    assert not pitch.LAUNCHES["viterbi_decode"]
