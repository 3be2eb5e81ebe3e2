"""``preprocess.extract_features_scan`` and ``extract_into_store`` take
``extract_features``'s keywords, as JAX's do through ``**static``
(preprocess.py:180-198, :241-259): at a non-default ``pitch_params`` and
in ``highpass_mode="time"`` both equal JAX's, with JAX's draws
(``uniform(fold_in(key, k), [B, N])`` for batch k) injected.

The bars: the mel within 1e-5 (test_torch_preprocess.py's); the
normalized F0's voicing on 99.5% of each batch's frames and, where both
voice, its value within 1e-3: an utterance's last frame takes its lag
from the correlation's FFT rounding times 1e6 in either package
(ROADMAP.md C, limits), and through the speaker normalization's mean and
std a log-F0 difference d there moves each of the utterance's n voiced
values by about d / (8 n std) (1.1e-4 at most on these inputs;
test_torch_preprocess.py holds the tracker and the normalization apart
at their own bars)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu import preprocess as jpre
from speechsplit_tpu.ops import pitch as jpitch
from speechsplit_tpu_torch import preprocess
from speechsplit_tpu_torch.ops import pitch
from tests.speech_stimuli import default_utterance

KEY = jax.random.PRNGKey(11)
OPTIONS = dict(num_cands=10, trans_cost=0.4, block_viterbi=4,
               topk_by_sort=False)
F0_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops a call; one thread keeps them from contending with
    the other test processes for the cores. It changes no value."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def staged():
    """K = 2 batches of 2 speech-like utterances (M and F), one bucket of
    32,768 samples, and JAX's draws of each batch."""
    wavs = [default_utterance(seed, f0).wav[:n].astype(np.float32)
            for seed, f0, n in ((3, 120.0, 30000), (5, 220.0, 24000),
                                (6, 140.0, 32768), (8, 200.0, 20000))]
    batches = [preprocess.pad_batch(wavs[i : i + 2]) for i in (0, 2)]
    wav = np.stack([b for b, _ in batches])
    lengths = np.stack([n for _, n in batches])
    lo = np.array([[50.0, 100.0]] * 2, np.float32)
    hi = np.array([[250.0, 600.0]] * 2, np.float32)
    draws = [np.array(jax.random.uniform(jax.random.fold_in(KEY, k),
                                         wav.shape[1:])) for k in range(2)]
    return wav, lengths, lo, hi, draws


def _hold(mel, f0, mel_j, f0_j, lengths):
    """The module's bars, batch by batch over each utterance's frames."""
    np.testing.assert_allclose(mel, mel_j, rtol=0, atol=1e-5)
    valid = np.arange(f0.shape[-1])[None, None, :] * 256 < lengths[..., None]
    voiced, voiced_j = f0 > -1e9, f0_j > -1e9
    for k in range(len(f0)):
        assert (voiced == voiced_j)[k][valid[k]].mean() > 0.995
    both = voiced & voiced_j
    np.testing.assert_allclose(f0[both], f0_j[both], rtol=0, atol=F0_TOL)
    assert voiced_j[valid].mean() > 0.2


@pytest.mark.parametrize("highpass_mode", ["stft", "time"])
def test_scan_forwards_the_front_end_keywords(staged, highpass_mode):
    wav, lengths, lo, hi, draws = staged
    mel_j, f0_j = map(np.asarray, jpre.extract_features_scan(
        *map(jnp.asarray, (wav, lengths, lo, hi)), KEY,
        highpass_mode=highpass_mode,
        pitch_params=jpitch.PitchParams(**OPTIONS)))
    params = pitch.PitchParams(**OPTIONS)
    mel, f0 = preprocess.extract_features_scan(
        wav, lengths, lo, hi, uniform=[torch.from_numpy(d) for d in draws],
        device="cpu", highpass_mode=highpass_mode, pitch_params=params)
    assert mel.shape == mel_j.shape == (2, 2, 129, 80)
    _hold(mel.numpy(), f0.numpy(), mel_j, f0_j, lengths)
    # each batch is extract_features on it with the same keywords
    one = preprocess.extract_features(
        wav[1], lengths[1], lo[1], hi[1], uniform=torch.from_numpy(draws[1]),
        device="cpu", highpass_mode=highpass_mode, pitch_params=params)
    for got, want in zip((mel[1], f0[1]), one):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    if highpass_mode == "time":
        plain = preprocess.extract_features_scan(
            wav, lengths, lo, hi, uniform=[torch.from_numpy(d)
                                           for d in draws], device="cpu")
        assert not torch.equal(plain[0], mel)


def _masked(mel_j, f0_j, lengths):
    """JAX's scan output masked past each utterance's frame count, as the
    store writes it (preprocess.py:296-300)."""
    frames = lengths // 256 + 1
    keep = np.arange(mel_j.shape[2])[None, None, :] < frames[..., None]
    return (np.where(keep[..., None], mel_j, 0.0),
            np.where(keep, f0_j, pitch.UNVOICED_LOG_F0))


def test_store_forwards_the_front_end_keywords(staged):
    """At ``highpass_mode="time"`` and a non-default ``pitch_params``
    against JAX's scan, masked as a store row is (JAX's
    ``extract_into_store`` cannot take ``pitch_params``: it is not among
    its static argument names), and at ``highpass_mode="time"`` alone
    against JAX's ``extract_into_store`` itself."""
    wav, lengths, lo, hi, draws = staged
    uids = np.array([[3, 0], [1, 4]])
    uniform = [torch.from_numpy(d) for d in draws]
    inputs = tuple(map(jnp.asarray, (wav, lengths, lo, hi)))

    def port_store(**static):
        mel = torch.zeros((5, 140, 80))
        f0 = torch.full((5, 140), pitch.UNVOICED_LOG_F0)
        return [t.numpy() for t in preprocess.extract_into_store(
            mel, f0, wav, lengths, lo, hi, uids, uniform=uniform, **static)]

    def rows(mel_store, f0_store):
        return (mel_store[uids][:, :, :129], f0_store[uids][:, :, :129])

    mel_s, f0_s = port_store(highpass_mode="time",
                             pitch_params=pitch.PitchParams(**OPTIONS))
    mel_j, f0_j = _masked(*map(np.asarray, jpre.extract_features_scan(
        *inputs, KEY, highpass_mode="time",
        pitch_params=jpitch.PitchParams(**OPTIONS))), lengths)
    _hold(*rows(mel_s, f0_s), mel_j, f0_j, lengths)
    assert not mel_s[2].any() and (f0_s[:, 129:] == pitch.UNVOICED_LOG_F0
                                   ).all()

    mel_s, f0_s = port_store(highpass_mode="time")
    mel_store, f0_store = map(np.asarray, jpre.extract_into_store(
        jnp.zeros((5, 140, 80)), jnp.full((5, 140), pitch.UNVOICED_LOG_F0),
        *inputs, jnp.asarray(uids), KEY, highpass_mode="time"))
    np.testing.assert_allclose(mel_s, mel_store, rtol=0, atol=1e-5)
    _hold(*rows(mel_s, f0_s), *rows(mel_store, f0_store), lengths)
