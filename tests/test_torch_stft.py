"""The port's STFT and mel front end against the JAX package's
(``ops/stft.py``), on speech-like stimuli, and the high-pass's bin gain
(``ops/filters.py`` coefficients)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import filters as jfilters
from speechsplit_tpu.ops import stft as jstft
from speechsplit_tpu.preprocess import _stft_bin_gain as jax_bin_gain
from speechsplit_tpu_torch.ops import filters, stft
from speechsplit_tpu_torch.preprocess import _stft_bin_gain
from tests.speech_stimuli import default_utterance


def _wavs(n=16384):
    """[2, n] float32: two speech-like utterances, cut to n samples."""
    return np.stack([default_utterance(seed, f0).wav[:n]
                     for seed, f0 in ((3, 120.0), (5, 220.0))]
                    ).astype(np.float32)


@pytest.mark.parametrize("n_fft", [1024, 512])
def test_window_and_filterbank_equal_jax(n_fft):
    np.testing.assert_array_equal(stft.hann_window(n_fft),
                                  jstft.hann_window(n_fft))
    np.testing.assert_array_equal(stft.mel_filterbank(16000, n_fft, 80),
                                  jstft.mel_filterbank(16000, n_fft, 80))


def test_frame_signal_equals_jax():
    x = _wavs(4000)
    want = np.asarray(jstft.frame_signal(jnp.asarray(x), 1024, 256))
    got = stft.frame_signal(torch.from_numpy(x), 1024, 256).numpy()
    np.testing.assert_array_equal(got, want)


def test_magnitude_stft():
    x = _wavs()
    want = np.asarray(jstft.magnitude_stft(jnp.asarray(x)))
    got = stft.magnitude_stft(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16384 // 256 + 1, 513)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("with_gain", [False, True])
def test_mel_spectrogram(with_gain):
    x = _wavs()
    gain = jax_bin_gain(30.0, 16000.0, 5, 1024) if with_gain else None
    np.testing.assert_array_equal(
        _stft_bin_gain(30.0, 16000.0, 5, 1024),
        jax_bin_gain(30.0, 16000.0, 5, 1024))
    want = np.asarray(jstft.mel_spectrogram(
        jnp.asarray(x), bin_gain=None if gain is None else jnp.asarray(gain)))
    got = stft.mel_spectrogram(
        torch.from_numpy(x),
        bin_gain=None if gain is None else torch.from_numpy(gain)).numpy()
    assert got.shape == want.shape == (2, 65, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_butter_highpass_equals_jax():
    for got, want in zip(filters.butter_highpass(30.0, 16000.0),
                         jfilters.butter_highpass(30.0, 16000.0)):
        np.testing.assert_array_equal(got, want)


def test_exact_float32_restores_the_switches():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with stft.exact_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
