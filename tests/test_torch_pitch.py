"""The port's pitch tracker (``ops/pitch.py``) against the JAX package's:
the NCCF, the candidates on JAX's own NCCF fields (ties
included), the plain Viterbi decoder against ``_viterbi_scan`` on the
same candidate fields, and ``track_pitch`` end to end, with its default
options and with each other option (tests/test_torch_pitch_decoders.py
holds those options' parts alone). The decoder's CUDA kernel is held to
the plain decoder on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pitch as jpitch
from speechsplit_tpu_torch.ops import _build, pitch
from tests.speech_stimuli import default_utterance

HOP, WINDOW, KMIN, KMAX = 256, 120, 16000 // 600, 16000 // 50
SPAN = WINDOW + KMAX


def _speech(seed=3, f0=120.0, n=32768):
    return default_utterance(seed, f0).wav[:n].astype(np.float32)


def test_prefix_sum_rounds_as_jax_cumsum():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 70001) ** 2).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    got = pitch._prefix_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_nccf():
    """Every frame whose lagged windows lie inside the signal. Past a
    signal's end (zero padding) the lagged window's energy is 0, the
    normalization sits on its 1e-12 floor and the value is the
    correlation's rounding times 1e6 in either package; track_pitch's
    test covers those frames end to end."""
    x = _speech()
    n_frames = (len(x) - SPAN) // HOP + 1
    want = np.asarray(jpitch._nccf(jnp.asarray(x), n_frames, HOP, WINDOW,
                                   KMIN, KMAX))
    got = pitch._nccf(torch.from_numpy(x)[None], n_frames, HOP, WINDOW, KMIN,
                      KMAX)[0].numpy()
    assert got.shape == want.shape == (n_frames, KMAX - KMIN + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _tie_field():
    """An NCCF field with an all-masked row (no peak: every lag ties at
    -2), rows of equal peaks and a row of a plateau."""
    rng = np.random.RandomState(7)
    field = rng.uniform(-0.5, 1.0, (6, KMAX - KMIN + 1)).astype(np.float32)
    field[0] = -3.0  # flat below the mask value: no peak
    field[1] = -0.3
    field[1, 10::25] = 0.6  # equal isolated peaks
    field[2, 40:44] = 0.9  # a plateau: its first sample is the peak
    field[3, ::2] = 0.25  # peaks on every other lag, all equal
    field[3, 1::2] = 0.1
    return field


@pytest.mark.parametrize("field_kind", ["speech", "ties"])
def test_candidates_on_jax_nccf(field_kind):
    if field_kind == "speech":
        x = jnp.asarray(np.pad(_speech(), (0, 128 * HOP + SPAN)))
        field = np.array(jpitch._nccf(x, 129, HOP, WINDOW, KMIN, KMAX))
    else:
        field = _tie_field()
    lag_j, score_j = jpitch._candidates(jnp.asarray(field), KMIN,
                                        jpitch.PitchParams())
    lag_t, score_t = pitch._candidates(torch.from_numpy(field), KMIN,
                                       pitch.PitchParams())
    np.testing.assert_array_equal(score_t.numpy(), np.asarray(score_j))
    np.testing.assert_allclose(lag_t.numpy(), np.asarray(lag_j), rtol=0,
                               atol=1e-6)
    if field_kind == "ties":
        # the all-masked row keeps the first K lags, in order
        assert (score_t[0] == -2.0).all()
        np.testing.assert_array_equal(lag_t[0].numpy(),
                                      np.arange(12) + KMIN)


def _decoder_field(t, seed, kind):
    """[T, K] (lag, score): integer lags and scores on eighths (costs tie),
    some unusable; ``unusable`` makes every candidate unusable,
    ``equal`` every candidate the same."""
    rng = np.random.RandomState(seed)
    lag = np.floor(rng.uniform(26.0, 321.0, (t, 12))).astype(np.float32)
    score = (np.floor(rng.uniform(-1.6, 8.0, (t, 12))) / 8.0).astype(
        np.float32)
    if kind == "unusable":
        score = np.minimum(score, 0.3)
    elif kind == "equal":
        lag[:] = 100.0
        score[:] = 0.5
    return lag, score


@pytest.mark.parametrize("t", [1, 2, 129, 257])
@pytest.mark.parametrize("kind", ["random", "unusable", "equal"])
def test_plain_viterbi_equals_viterbi_scan(t, kind):
    lag, score = _decoder_field(t, 11 + t, kind)
    params = pitch.PitchParams()
    best_j, voiced_j = jpitch._viterbi_scan(jnp.asarray(lag),
                                            jnp.asarray(score), KMAX,
                                            jpitch.PitchParams())
    best_t, voiced_t = pitch._viterbi(torch.from_numpy(lag)[None],
                                      torch.from_numpy(score)[None], KMAX,
                                      params)
    np.testing.assert_array_equal(voiced_t[0].numpy(), np.asarray(voiced_j))
    np.testing.assert_array_equal(best_t[0].numpy(), np.asarray(best_j))


def test_decoder_states_batch_independent():
    """A batch decodes as its rows do alone (the kernel's warp an
    utterance has no cross-row state either)."""
    fields = [_decoder_field(129, s, "random") for s in (1, 2)]
    params = pitch.PitchParams()
    costs = pitch._local_costs(
        torch.from_numpy(np.stack([f[0] for f in fields])),
        torch.from_numpy(np.stack([f[1] for f in fields])), KMAX, params)[1:]
    both = pitch.viterbi_decode(*costs, 0.25, 0.3)
    for i in range(2):
        one = pitch.viterbi_decode(*(c[i : i + 1].contiguous()
                                     for c in costs), 0.25, 0.3)
        np.testing.assert_array_equal(both[i : i + 1].numpy(), one.numpy())
    assert both.dtype == torch.int32
    assert not pitch.LAUNCHES["viterbi_decode"]


@pytest.mark.parametrize("gender_range", [(50.0, 250.0), (100.0, 600.0)])
def test_track_pitch_end_to_end(gender_range):
    x = np.stack([_speech(3, 120.0), _speech(5, 220.0, 30000)
                  .tolist() + [0.0] * 2768]).astype(np.float32)
    lengths = np.array([32768, 30000], np.int32)
    lo, hi = (np.full(2, v, np.float32) for v in gender_range)
    want = np.asarray(jpitch.track_pitch(jnp.asarray(x), jnp.asarray(lengths),
                                         jnp.asarray(lo), jnp.asarray(hi)))
    got = pitch.track_pitch(torch.from_numpy(x), torch.from_numpy(lengths),
                            torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    assert got.shape == want.shape == (2, 129)
    voiced_j, voiced_t = want > -1e9, got > -1e9
    same = (voiced_j == voiced_t) & (~voiced_j | (np.abs(got - want) <= 1e-5))
    assert same.mean() > 0.995, same.mean()
    assert voiced_j.mean() > 0.2  # a tracker that voices nothing agrees too


@pytest.mark.parametrize("refused", [
    dict(parallel_viterbi=True), dict(block_viterbi=4),
    dict(topk_by_sort=False), dict(nccf_by_conv=True)])
def test_refused_decoders_raise(refused):
    """The four options the port once refused, each through track_pitch
    on one utterance against JAX's with the same option, at
    test_track_pitch_end_to_end's bar (tests/test_torch_pitch_decoders.py
    holds each part alone)."""
    x = _speech(7, 180.0, 16384)[None]
    args = (x, np.array([16384], np.int32), np.array([50.0], np.float32),
            np.array([600.0], np.float32))
    want = np.asarray(jpitch.track_pitch(
        *map(jnp.asarray, args), params=jpitch.PitchParams(**refused)))
    got = pitch.track_pitch(*map(torch.from_numpy, args),
                            params=pitch.PitchParams(**refused)).numpy()
    assert got.shape == want.shape == (1, 65)
    voiced_j, voiced_t = want > -1e9, got > -1e9
    same = (voiced_j == voiced_t) & (~voiced_j | (np.abs(got - want) <= 1e-5))
    assert same.mean() > 0.995, same.mean()
    assert voiced_j.mean() > 0.2


def test_kernel_wrapper_raises_without_a_library(monkeypatch, tmp_path):
    """The CUDA wrapper builds its library at first use; with no nvcc it
    raises instead of running the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    costs = (torch.zeros(1, 5, 12), torch.zeros(1, 5), torch.zeros(1, 5, 12))
    with pytest.raises(RuntimeError, match="nvcc"):
        pitch.viterbi_decode_cuda(*costs, 0.25, 0.3)
    assert not pitch.LAUNCHES["viterbi_decode"]


def test_kernel_limits_are_the_source():
    assert pitch.MAX_STATES == 32
    wide = (torch.zeros(1, 5, 32), torch.zeros(1, 5), torch.zeros(1, 5, 32))
    with pytest.raises(ValueError, match="candidates"):
        pitch.viterbi_decode_cuda(*wide, 0.25, 0.3)
    with pytest.raises(ValueError, match="float32"):
        pitch.viterbi_decode_cuda(torch.zeros(1, 5, 12, dtype=torch.float64),
                                  torch.zeros(1, 5), torch.zeros(1, 5, 12),
                                  0.25, 0.3)
