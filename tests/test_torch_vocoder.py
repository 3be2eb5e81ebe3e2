"""The port's Griffin-Lim vocoder (``vocoder.py``) against the JAX
package's, with JAX's initial-phase draws injected (JAX PRNG streams
cannot be reproduced in torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu import vocoder as jvocoder
from speechsplit_tpu.ops.stft import mel_spectrogram as jax_mel
from speechsplit_tpu_torch import vocoder
from speechsplit_tpu_torch.ops.stft import mel_filterbank
from tests.speech_stimuli import default_utterance

F = 513


def _mels():
    """Two mels of a speech-like utterance (40 and 57 frames: one
    32-frame bucket of 64)."""
    wav = default_utterance(3, 120.0).wav[:16384].astype(np.float32)
    mel = np.asarray(jax_mel(jnp.asarray(wav[None])))[0]
    return [mel[:40], mel[8:65]]


def _phase(batch, frames, seed=0):
    """JAX's draws for the initial phase: GriffinLimVocoder(seed)'s key
    over the [B, T_pad, F] magnitude (vocoder.py:195, :246)."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed),
                                       (batch, frames, F)))


def test_one_mel_consistency_iteration():
    rng = np.random.RandomState(0)
    basis = mel_filterbank()
    mel_amp = rng.uniform(1e-4, 1.0, (2, 32, 80)).astype(np.float32)
    mag = rng.uniform(1e-3, 1.0, (2, 32, F)).astype(np.float32)
    phase = _phase(2, 32)
    spec_j = jnp.asarray(mag) * jnp.exp(1j * (jnp.asarray(phase) * 2.0
                                              * jnp.pi))
    want = np.asarray(jvocoder.mel_consistency_project(
        spec_j, jnp.asarray(mel_amp), jnp.asarray(basis), 1024, 256, 1))
    spec_t = vocoder._with_phase(torch.from_numpy(mag),
                                 torch.from_numpy(phase))
    got = vocoder.mel_consistency_project(
        spec_t, torch.from_numpy(mel_amp), torch.from_numpy(basis), 1024,
        256, 1).numpy()
    assert got.shape == want.shape == (2, 32, F)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_synthesize_batch_8_iterations():
    mels = _mels()
    want = jvocoder.GriffinLimVocoder(n_iter=8).synthesize_batch(mels)
    voc = vocoder.GriffinLimVocoder(n_iter=8, device="cpu")
    got = voc.synthesize_batch(mels, uniform=torch.from_numpy(_phase(2, 64)))
    for g, w, m in zip(got, want, mels):
        assert len(g) == len(w) == (len(m) - 1) * 256
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def _db_error(wav, mel):
    """Mean |dB| between a wav's re-extracted mel and the target mel."""
    again = np.asarray(jax_mel(jnp.asarray(wav[None])))[0][: len(mel)]
    return float(np.abs(again - mel).mean()) * 100.0


def test_default_iterations_reach_jax_mel_error():
    mels = _mels()
    want = jvocoder.GriffinLimVocoder().synthesize_batch(mels)
    got = vocoder.GriffinLimVocoder(device="cpu").synthesize_batch(
        mels, uniform=torch.from_numpy(_phase(2, 64)))
    for g, w, m in zip(got, want, mels):
        assert abs(_db_error(g, m) - _db_error(w, m)) <= 0.01


def test_pcm16_within_one_lsb_of_the_float_path():
    mels = [np.clip(np.random.RandomState(3).rand(n, 80) * 0.6 + 0.2, 0, 1)
            .astype(np.float32) for n in (40, 64, 57)]
    voc = vocoder.GriffinLimVocoder(n_iter=8, device="cpu")
    floats = voc.synthesize_batch(mels)
    pcm = voc.synthesize_batch(mels, pcm16=True)
    for q, w in zip(pcm, floats):
        assert q.dtype == np.int16 and len(q) == len(w)
        assert np.abs(q.astype(np.float64) - w * 32767.0).max() <= 1.0


def test_batched_equals_single_and_reseeds():
    mels = _mels()
    voc = vocoder.GriffinLimVocoder(n_iter=8, device="cpu")
    draws = torch.from_numpy(_phase(2, 64))
    both = voc.synthesize_batch(mels, uniform=draws)
    for i, mel in enumerate(mels):
        one = voc.synthesize_batch([mel], uniform=draws[i : i + 1])[0]
        np.testing.assert_allclose(both[i], one, rtol=0, atol=1e-6)
    # the vocoder's own generator, reseeded every call: same mels, same audio
    first, second = voc.synthesize_batch(mels), voc.synthesize_batch(mels)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def _mel_amp_and_bases(seed=5, frames=24):
    rng = np.random.RandomState(seed)
    basis = mel_filterbank()
    mel_amp = rng.uniform(1e-4, 1.0, (2, frames, 80)).astype(np.float32)
    return mel_amp, basis, np.linalg.pinv(basis).astype(np.float32)


def test_phase_draws_are_needed():
    mel_amp, basis, inv_basis = map(torch.from_numpy, _mel_amp_and_bases())
    with pytest.raises(ValueError, match="draws"):
        vocoder.mel_griffin_lim(mel_amp, basis, inv_basis, n_iter=1)
    wav = vocoder.mel_griffin_lim(mel_amp, basis, inv_basis, n_iter=2,
                                  generator=torch.Generator().manual_seed(0))
    assert wav.shape == (2, 23 * 256) and torch.isfinite(wav).all()


def test_mel_griffin_lim_equals_jax():
    mel_amp, basis, inv_basis = _mel_amp_and_bases()
    key = jax.random.PRNGKey(2)
    want = np.asarray(jvocoder.mel_griffin_lim(
        jnp.asarray(mel_amp), jnp.asarray(basis), jnp.asarray(inv_basis),
        key, n_iter=4))
    draws = np.array(jax.random.uniform(key, (2, 24, F)))
    got = vocoder.mel_griffin_lim(
        *map(torch.from_numpy, (mel_amp, basis, inv_basis)), n_iter=4,
        uniform=torch.from_numpy(draws))
    assert got.shape == want.shape == (2, 23 * 256)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
