"""The port's feature extraction (``preprocess.py``) and wav readers
(``data/prepare.py``) against the JAX package's, with JAX's dither draws
injected (JAX PRNG streams cannot be reproduced in torch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speechsplit_tpu import preprocess as jpre
from speechsplit_tpu.data import prepare as jprepare
from speechsplit_tpu.ops import filters as jfilters
from speechsplit_tpu.ops import pitch as jpitch
from speechsplit_tpu_torch import preprocess
from speechsplit_tpu_torch.data import prepare
from speechsplit_tpu_torch.ops import filters, pitch
from tests.speech_stimuli import default_utterance

KEY = jax.random.PRNGKey(4)


def _batch():
    """Two speech-like utterances (M and F) of 30,000 and 24,000 samples,
    padded to one 32,768-sample bucket."""
    wavs = [default_utterance(3, 120.0).wav[:30000].astype(np.float32),
            default_utterance(5, 220.0).wav[:24000].astype(np.float32)]
    batch, lengths = preprocess.pad_batch(wavs)
    lo = np.array([50.0, 100.0], np.float32)
    hi = np.array([250.0, 600.0], np.float32)
    return batch, lengths, lo, hi


def _f0_agreement(got, want):
    """The share of frames whose voicing agrees and whose log-F0, where
    voiced, is within 1e-5 (tests/test_pitch.py:214's bar)."""
    voiced_g, voiced_w = got > -1e9, want > -1e9
    same = (voiced_g == voiced_w) & (~voiced_w | (np.abs(got - want) <= 1e-5))
    return same.mean()


def _dithered(batch, uniform):
    """The signal the tracker sees (preprocess.py:113-127)."""
    return batch * 0.96 + (uniform - 0.5) * 2.0 * 1e-6


def test_extract_features_equals_jax():
    """The mel within 1e-5. The F0 through its two parts, each held to
    JAX: the tracker on JAX's dithered signal at the track_pitch bar over
    the batch's frames, and the speaker normalization on JAX's own track
    within 1e-5 (the mean and variance are float32 sums of about 100
    log-F0 values near 5, taken in another order); the port's F0 output is that composition on its own
    dithered signal. (An utterance's last frame, whose lagged windows
    reach into the zero padding, takes its lag from the correlation's FFT
    rounding times 1e6 in either package: ROADMAP.md C, limits. Through
    the normalization's mean and std a log-F0 difference there moves the
    utterance's other normalized values.) JAX runs its extractor
    unjitted, so that its dithered signal is the one rebuilt here."""
    batch, lengths, lo, hi = _batch()
    assert batch.shape == (2, 32768)
    uniform = np.array(jax.random.uniform(KEY, batch.shape))
    mel_j, f0_j = map(np.asarray, jpre._extract_core(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(lo),
        jnp.asarray(hi), KEY))
    mel_t, f0_t = preprocess.extract_features(
        batch, lengths, lo, hi, uniform=torch.from_numpy(uniform),
        device="cpu")
    assert mel_t.shape == mel_j.shape == (2, 129, 80)
    np.testing.assert_allclose(mel_t.numpy(), mel_j, rtol=0, atol=1e-5)

    y_j = _dithered(jnp.asarray(batch), jnp.asarray(uniform))
    y_t = _dithered(torch.from_numpy(batch), torch.from_numpy(uniform))
    bounds = (lengths, lo, hi)
    logf0_j = np.asarray(jpitch.track_pitch(y_j, *map(jnp.asarray, bounds)))
    logf0_t = pitch.track_pitch(torch.from_numpy(np.array(y_j)),
                                *map(torch.from_numpy, bounds))
    valid = np.arange(129)[None, :] * 256 < lengths[:, None]
    assert _f0_agreement(logf0_t.numpy()[valid], logf0_j[valid]) > 0.995
    np.testing.assert_allclose(
        preprocess.normalize_log_f0(torch.from_numpy(logf0_j)).numpy(),
        f0_j, rtol=0, atol=1e-5)
    own = pitch.track_pitch(y_t, *map(torch.from_numpy, bounds))
    np.testing.assert_array_equal(
        f0_t.numpy(), preprocess.normalize_log_f0(own).numpy())
    voiced_t, voiced_j = f0_t.numpy() > -1e9, f0_j > -1e9
    assert (voiced_t == voiced_j)[valid].mean() > 0.995
    assert voiced_j[valid].mean() > 0.2


def test_waveform_highpass_is_refused():
    """The waveform high-pass (``highpass_mode="time"``, which the port
    once refused) against JAX's, with JAX's draws, at
    test_extract_features_equals_jax's bars: the mel within 1e-5, the
    high-passed dithered signal within 1e-6 (float32 rffts of 65,536
    points), the tracker on JAX's signal on 99.5% of the frames, and the
    voicing of the normalized F0 likewise. A mode neither package has
    still raises."""
    batch, lengths, lo, hi = _batch()
    uniform = np.array(jax.random.uniform(KEY, batch.shape))
    mel_j, f0_j = map(np.asarray, jpre._extract_core(
        jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(lo),
        jnp.asarray(hi), KEY, highpass_mode="time"))
    mel_t, f0_t = preprocess.extract_features(
        batch, lengths, lo, hi, uniform=torch.from_numpy(uniform),
        device="cpu", highpass_mode="time")
    assert mel_t.shape == mel_j.shape == (2, 129, 80)
    np.testing.assert_allclose(mel_t.numpy(), mel_j, rtol=0, atol=1e-5)

    y_j = _dithered(jfilters.zero_phase_highpass(
        jnp.asarray(batch), jnp.asarray(lengths)), jnp.asarray(uniform))
    y_t = _dithered(filters.zero_phase_highpass(
        torch.from_numpy(batch), torch.from_numpy(lengths)),
        torch.from_numpy(uniform))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=1e-6)
    bounds = (lengths, lo, hi)
    logf0_j = np.asarray(jpitch.track_pitch(y_j, *map(jnp.asarray, bounds)))
    logf0_t = pitch.track_pitch(torch.from_numpy(np.array(y_j)),
                                *map(torch.from_numpy, bounds))
    valid = np.arange(129)[None, :] * 256 < lengths[:, None]
    assert _f0_agreement(logf0_t.numpy()[valid], logf0_j[valid]) > 0.995
    own = pitch.track_pitch(y_t, *map(torch.from_numpy, bounds))
    np.testing.assert_array_equal(
        f0_t.numpy(), preprocess.normalize_log_f0(own).numpy())
    voiced_t, voiced_j = f0_t.numpy() > -1e9, f0_j > -1e9
    assert (voiced_t == voiced_j)[valid].mean() > 0.995
    assert voiced_j[valid].mean() > 0.2
    with pytest.raises(ValueError, match="fft"):
        preprocess.extract_features(batch, lengths, lo, hi,
                                    uniform=torch.zeros(batch.shape),
                                    device="cpu", highpass_mode="fft")


def test_int16_input_equals_its_float32():
    batch, lengths, lo, hi = _batch()
    pcm = np.round(batch * 32767).astype(np.int16)
    uniform = torch.rand(pcm.shape, generator=torch.Generator().manual_seed(1))
    got = preprocess.extract_features(pcm, lengths, lo, hi, uniform=uniform,
                                      device="cpu")
    want = preprocess.extract_features(pcm.astype(np.float32) / 32768.0,
                                       lengths, lo, hi, uniform=uniform,
                                       device="cpu")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_generator_reseeded_gives_the_same_features():
    batch, lengths, lo, hi = _batch()
    runs = [preprocess.extract_features(
        batch, lengths, lo, hi, device="cpu",
        generator=torch.Generator().manual_seed(9)) for _ in range(2)]
    for g, w in zip(*runs):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="dither"):
        preprocess.extract_features(batch, lengths, lo, hi, device="cpu")


@pytest.mark.parametrize("kinds", [("int16", "int16"), ("float", "float"),
                                   ("int16", "float")])
def test_pad_batch_and_frame_count_equal_jax(kinds):
    rng = np.random.RandomState(0)
    wavs = []
    for kind, n in zip(kinds, (1000, 40000)):
        w = rng.uniform(-0.5, 0.5, n)
        wavs.append((w * 32767).astype(np.int16) if kind == "int16"
                    else w.astype(np.float32))
    got, got_len = preprocess.pad_batch(wavs)
    want, want_len = jpre.pad_batch(wavs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)
    for n in (0, 255, 256, 32768, 40000):
        assert preprocess.frame_count(n) == jpre.frame_count(n)


@pytest.mark.parametrize("kind", ["int16", "int32", "float32",
                                  "stereo_int16"])
def test_read_wav_equals_jax(kind, tmp_path):
    rng = np.random.RandomState(2)
    x = rng.uniform(-0.8, 0.8, (3000, 2 if kind.startswith("stereo") else 1))
    x = x[:, 0] if x.shape[1] == 1 else x
    data = {"int16": lambda: (x * 32767).astype(np.int16),
            "stereo_int16": lambda: (x * 32767).astype(np.int16),
            "int32": lambda: (x * 2 ** 31).astype(np.int32),
            "float32": lambda: x.astype(np.float32)}[kind]()
    path = str(tmp_path / f"{kind}.wav")
    wavfile.write(path, 16000, data)
    got = prepare.read_wav(path)
    np.testing.assert_array_equal(got, jprepare.read_wav(path))
    assert got.dtype == np.float32
    pcm = prepare.read_wav_pcm(path)
    np.testing.assert_array_equal(pcm, jprepare.read_wav_pcm(path))
    assert (pcm.dtype == np.int16) == (kind == "int16")
    with pytest.raises(ValueError, match="sample rate"):
        prepare.read_wav(path, expect_rate=22050)
