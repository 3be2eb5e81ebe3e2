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


def _f0_losses(f0, len_org, logits):
    """The F0-converter loss of both packages on one batch, the model
    replaced by a stub that returns ``logits``: JAX's from its own train
    step (``make_f0_train_step_fn``), the port's ``f0_loss``."""
    import jax
    import types

    from speechsplit_tpu.data.collator import Batch as JaxBatch
    from speechsplit_tpu.training import train_step as jax_train_step
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.data import Batch
    from speechsplit_tpu_torch.training import f0_loss
    from tests.test_pallas_multilstm import _tiny_config

    cfg = _tiny_config().replace(residual_dtype="float32",
                                 adam_mu_dtype="float32")
    b, t = f0.shape
    mel = np.zeros((b, t, cfg.dim_freq), np.float32)
    stub = types.SimpleNamespace(
        apply=lambda v, mel, onehot, train, rngs: (
            jnp.asarray(logits) + 0.0 * v["params"]["w"]))
    params = {"w": jnp.zeros(())}
    tx = jax_train_step.make_optimizer(cfg)
    state = jax_train_step.TrainState(params, tx.init(params),
                                      jnp.zeros((), jnp.int32))
    batch = JaxBatch(mel, np.zeros((b, cfg.dim_spk_emb), np.float32),
                     f0[..., None], len_org)
    _, want = jax_train_step.make_f0_train_step_fn(cfg, stub)(
        state, batch, jax.random.PRNGKey(0))
    port_cfg = SpeechSplitConfig().replace(dim_f0=cfg.dim_f0)
    got = f0_loss(port_cfg, lambda *a, **k: torch.from_numpy(logits),
                  Batch(*(torch.from_numpy(x) for x in (
                      mel, batch.spk_emb, batch.f0,
                      len_org.astype(np.int64)))), None)
    return float(got), float(want)


def test_f0_loss_past_the_last_bin_is_nan_as_jax():
    """A contour value of about 1.002 or more quantizes to id 257, past
    the 257 classes: JAX's loss is NaN there (NaN x mask 0), and the
    port's too, where ``F.cross_entropy`` raised."""
    f0 = np.array([[0.5, 1.0, 1.002, -1e10]], np.float32)
    got, want = _f0_losses(f0, np.array([3], np.int32),
                           np.zeros((1, 4, 257), np.float32))
    assert np.isnan(want) and np.isnan(got)


def test_f0_loss_in_range_unchanged(rng):
    """In range the loss equals JAX's, and ``F.cross_entropy``'s (the
    port's loss before the fix) bit for bit."""
    import torch.nn.functional as F

    f0 = np.where(rng.rand(3, 16) < 0.3, 0.0, rng.rand(3, 16))
    f0 = f0.astype(np.float32)
    f0[:, 12:] = -1e10
    len_org = np.array([12, 9, 16], np.int32)
    logits = rng.randn(3, 16, 257).astype(np.float32)
    got, want = _f0_losses(f0, len_org, logits)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ids = quantize.quantize_f0(torch.from_numpy(f0))
    ce = F.cross_entropy(torch.from_numpy(logits).transpose(1, 2), ids,
                         reduction="none")
    valid = (torch.arange(16)[None, :]
             < torch.from_numpy(len_org)[:, None]).float()
    assert got == float(torch.sum(ce * valid) / torch.sum(valid))


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
