"""The port's synthetic corpora (``data/synthetic.py``) against the JAX
package's: stimuli and their ground truth, the speakers' formant sets,
and ``make_corpus`` wav trees in both formant modes, bit for bit."""

import os

import numpy as np
import pytest

from speechsplit_tpu.data import synthetic as jsynthetic
from speechsplit_tpu_torch.data import synthetic


def _same_stimulus(got, want):
    for name in ("wav", "f0_per_sample", "voiced_per_sample", "transition"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for g, w in zip(got.frame_ground_truth(), want.frame_ground_truth()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed, f0", [(3, 120.0), (5, 220.0)])
def test_default_utterance_equals_jax(seed, f0):
    got = synthetic.default_utterance(seed, f0)
    assert got.wav.dtype == np.float32
    _same_stimulus(got, jsynthetic.default_utterance(seed, f0))


@pytest.mark.parametrize("seed, f0, formants", [
    (0, 110.0, None), (7, 210.0, synthetic.VOWEL_FORMANTS[2])])
def test_random_utterance_equals_jax(seed, f0, formants):
    got = synthetic.random_utterance(seed, f0, duration_s=1.0,
                                     formants=formants)
    _same_stimulus(got, jsynthetic.random_utterance(
        seed, f0, duration_s=1.0, formants=formants))


def test_speaker_formant_sets_equal_jax():
    got = synthetic.speaker_formant_sets(7, np.random.RandomState(4))
    assert got == jsynthetic.speaker_formant_sets(7, np.random.RandomState(4))
    assert len(set(got)) == 7


def _tree(root):
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, root)] = fh.read()
    return files


@pytest.mark.parametrize("distinct_formants", [False, True])
def test_make_corpus_equals_jax(tmp_path, distinct_formants):
    kwargs = dict(n_speakers=3, seed=2, duration_s=0.6,
                  distinct_formants=distinct_formants)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    paths = synthetic.make_corpus(ours, 5, **kwargs)
    want = jsynthetic.make_corpus(theirs, 5, **kwargs)
    assert [os.path.relpath(p, ours) for p in paths] == [
        os.path.relpath(p, theirs) for p in want]
    got_tree, want_tree = _tree(ours), _tree(theirs)
    assert got_tree == want_tree
    assert ("_speakers.json" in got_tree) == distinct_formants
    assert sum(name.endswith(".wav") for name in got_tree) == 5
