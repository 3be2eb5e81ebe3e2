"""The port's F0 quantization and mask helpers against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import torch

from speechsplit_tpu.ops import masks as jmasks
from speechsplit_tpu.ops import quantize as jquant
from speechsplit_tpu_torch.ops import masks, quantize


def test_quantize_f0_matches_jax(rng):
    # voiced values, exact bin midpoints (round half to even), unvoiced
    x = np.concatenate([
        rng.rand(200), (np.arange(10) + 0.5) / 255.0, [0.0, -1e10, -0.5],
    ]).astype(np.float32)
    ids = quantize.quantize_f0(torch.from_numpy(x))
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jquant.quantize_f0(x)))
    onehot = quantize.quantize_f0_onehot(torch.from_numpy(x))
    assert onehot.dtype == torch.float32 and onehot.shape == (213, 257)
    np.testing.assert_array_equal(onehot.numpy(),
                                  np.asarray(jquant.quantize_f0_onehot(x)))


def test_quantize_f0_onehot_out_of_range_gives_zero_rows_as_jax():
    """Values past the top bin (about 1.002 and up) give all-zero rows, as
    ``jax.nn.one_hot`` does for an id past its classes; 0 and negative
    values are unvoiced (bin 0)."""
    x = np.array([0.5, 1.0, 1.002, 5.0, -0.3, 0.0], np.float32)
    got = quantize.quantize_f0_onehot(torch.from_numpy(x), 256).numpy()
    want = np.asarray(jquant.quantize_f0_onehot(x, 256))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(-1), [1, 1, 0, 0, 1, 1])
    assert got[4, 0] == got[5, 0] == 1


def test_speaker_normalization_matches_jax(rng):
    f0 = (rng.randn(64) * 0.5 + 5.0).astype(np.float32)
    voiced = rng.rand(64) > 0.3
    got = quantize.speaker_normalization(
        torch.from_numpy(f0), torch.from_numpy(voiced), 5.1, 0.2)
    want = jquant.speaker_normalization(jnp.asarray(f0), jnp.asarray(voiced),
                                        5.1, 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_masks_match_jax():
    lengths = np.array([0, 3, 7], np.int32)
    got = masks.get_mask_from_lengths(torch.from_numpy(lengths), 7)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmasks.get_mask_from_lengths(lengths, 7)))
    x = np.ones((2, 5, 3), np.float32)
    padded, n = masks.pad_time_axis(x, 8)
    want, n_want = jmasks.pad_time_axis(x, 8)
    assert n == n_want == 3
    np.testing.assert_array_equal(padded, want)
