"""The port's neural vocoder (``vocoder_neural.py``) on the shipped
``assets/vocoder_istft_100k.npz`` against the JAX package's, both loading
the asset themselves, on mels of a speech-like utterance.

Bars:
- the head's complex spectrum within 1e-5 of its largest magnitude
  (``SPEC_TOL``): a wrong flax default (LayerNorm epsilon 1e-5, exact
  GELU) moves it by about 1e-3;
- the waveform of the head alone (``refine_iters=0``, an iSTFT of that
  spectrum) within ``WAV_TOL[0]`` of its largest magnitude, after 48
  mel-consistency iterations within ``WAV_TOL[48]``. Each iteration
  renders, re-analyzes and rescales the previous one's output, so the
  two packages' float32 roundings grow with the iterations: measured on
  these mels (CPU) 1.8e-6 of the largest magnitude after 0, 1 and 4
  iterations, 5.7e-6 after 16, 6.4e-5 after 48 (mean 1.8e-5 of the mean
  magnitude). The bars are about four times the measured values: 1e-5
  and 3e-4;
- ``synthesize_batch(pcm16=True)`` after 48 iterations within
  ``PCM16_LSB`` codes of JAX's: the waveform bar at the 0.9 peak, 3e-4 x
  0.9 x 32767 = 8.8 codes, plus one of rounding (measured: 2 codes at
  most, about 12% of the samples one or two codes off).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu import vocoder_neural as jvn
from speechsplit_tpu_torch import vocoder_neural as vn
from speechsplit_tpu_torch.ops.stft import mel_spectrogram
from tests.speech_stimuli import default_utterance

SPEC_TOL = 1e-5
WAV_TOL = {0: 1e-5, 48: 3e-4}
PCM16_LSB = 10


def speech_mels():
    """Two mels of a speech-like utterance, 40 and 57 frames (one
    32-frame bucket of 64, so the batch carries zero frames too)."""
    wav = default_utterance(3, 120.0).wav[:16384].astype(np.float32)
    mel = mel_spectrogram(torch.from_numpy(wav[None]))[0].numpy()
    return [mel[:40], mel[8:65]]


@pytest.fixture(scope="module")
def vocoders():
    """(JAX's params, the port's vocoder at each refinement) from the
    asset."""
    jparams = jvn._load_npz_params(jvn.default_checkpoint())
    port = {r: vn.load_vocoder("default", refine_iters=r, device="cpu")
            for r in (0, 48)}
    return jparams, port


def _batch(mels):
    t = -(-max(len(m) for m in mels) // 32) * 32
    out = np.zeros((len(mels), t, 80), np.float32)
    for i, m in enumerate(mels):
        out[i, : len(m)] = m
    return out


def test_head_spectrum_matches_jax(vocoders):
    jparams, port = vocoders
    batch = _batch(speech_mels())
    want = np.asarray(jvn.NeuralVocoderModel().apply(
        {"params": jparams}, jnp.asarray(batch), method="spec"))
    got = port[0].spectrum(torch.from_numpy(batch)).numpy()
    assert got.shape == want.shape == (2, 64, 513)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= SPEC_TOL * scale


@pytest.mark.parametrize("refine", [0, 48])
def test_waveforms_match_jax(vocoders, refine):
    jparams, port = vocoders
    batch = _batch(speech_mels())
    jax_vocoder = jvn.NeuralVocoder(jparams, refine_iters=refine)
    want = np.asarray(jax_vocoder._apply(jax_vocoder.params,
                                         jnp.asarray(batch)))
    got = port[refine].waveforms(torch.from_numpy(batch)).numpy()
    assert got.shape == want.shape == (2, 63 * 256)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= WAV_TOL[refine], err


def test_synthesize_batch_trims_and_quantizes_as_jax(vocoders):
    jparams, port = vocoders
    mels = speech_mels()
    want = jvn.NeuralVocoder(jparams, refine_iters=48).synthesize_batch(
        mels, pcm16=True)
    got = port[48].synthesize_batch(mels, pcm16=True)
    floats = port[48].synthesize_batch(mels)
    for g, w, f, mel in zip(got, want, floats, mels):
        n = (len(mel) - 1) * 256
        assert g.dtype == np.int16 and len(g) == len(w) == len(f) == n
        assert int(np.abs(g.astype(np.int32) - w).max()) <= PCM16_LSB
        assert f.dtype == np.float32
        assert float(np.abs(f).max()) == pytest.approx(0.9, rel=1e-6)
        assert float(np.abs(g - f * 32767.0).max()) <= 1.0
    one = port[0](mels[0])
    assert one.shape == ((len(mels[0]) - 1) * 256,)


def test_asset_architecture_and_key_layout(vocoders):
    _, port = vocoders
    v = port[0]
    assert (v.n_fft, v.hop, v.sample_rate) == (1024, 256, 16000)
    sd = vn.npz_to_state_dict(vn.read_npz(vn.default_checkpoint()))
    assert sd["backbone.block_5.conv_time.weight"].shape == (256, 256, 5)
    assert sd["backbone.head.weight"].shape == (3 * 513, 256)
    assert sd["backbone.final_norm.weight"].dtype == torch.float32
    assert len(sd) == sum(1 for _ in v.model.state_dict())
    assert v.model.backbone.depth == 6
    raw = np.load(vn.default_checkpoint())
    np.testing.assert_array_equal(
        sd["backbone.embed.weight"].numpy(),
        raw["backbone/embed/kernel"].astype(np.float32).T)


def test_load_vocoder_refusals(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        vn.load_vocoder(str(tmp_path), device="cpu")
    missing = str(tmp_path / "nope.npz")
    with pytest.raises(FileNotFoundError, match="nope.npz"):
        vn.load_vocoder(missing, device="cpu")
    broken = tmp_path / "broken.npz"
    broken.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="broken.npz"):
        vn.load_vocoder(str(broken), device="cpu")
    assert os.path.isfile(vn.default_checkpoint())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vn.load_vocoder("default")
