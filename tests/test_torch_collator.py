"""The port's Collator against the JAX package's: bit-equal batches
from the same samples and the same numpy generator seed."""

import numpy as np
import pytest

from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu.data.collator import Batch as JaxBatch
from speechsplit_tpu.data.collator import Collator as JaxCollator
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.data import Batch, Collator


def _samples(seed, n=9):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        # utterances shorter than the shortest crop, and long ones
        length = int(rng.integers(20, 300)) if i else 40
        mel = rng.normal(0.5, 0.5, (length, 80)).astype(np.float32)
        f0 = np.where(rng.random(length) < 0.3, 0.0,
                      rng.random(length)).astype(np.float32)
        emb = np.eye(82, dtype=np.float32)[i]
        out.append((mel, emb, f0))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collator_matches_jax_bit_for_bit(seed):
    samples = _samples(seed)
    want = JaxCollator(JaxConfig())(samples, np.random.default_rng(seed))
    got = Collator(SpeechSplitConfig())(samples, np.random.default_rng(seed))
    assert Batch._fields == JaxBatch._fields
    for name in Batch._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.mel.shape == (9, 192, 80) and got.f0.shape == (9, 192, 1)
    assert got.len_org[0] == 40  # capped at the utterance's length
    assert float(got.mel.max()) <= 1.0 and float(got.mel.min()) >= 0.0
