"""The port's random resampling against the JAX package's: the
deterministic core on the same draws, and the torch draws' laws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import interp as jax_interp
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.ops import interp

CFG = SpeechSplitConfig()
NUM_SEG = CFG.max_len_seq // CFG.min_len_seg + 1
SPAN = 2 * CFG.max_len_seg
LAWS = dict(min_len_seg=CFG.min_len_seg, max_len_seg=CFG.max_len_seg,
            max_len_seq=CFG.max_len_seq, max_len_pad=CFG.max_len_pad)


def _draws(r, batch, num_seg=NUM_SEG):
    scales = r.uniform(0.5, 1.5, size=(batch, num_seg)).astype(np.float32)
    len_seg = r.randint(CFG.min_len_seg, CFG.max_len_seg,
                        size=(batch, num_seg)).astype(np.int32)
    return scales, len_seg


@pytest.fixture(autouse=True)
def gather_form(monkeypatch):
    """The JAX side in its gather form, the form the port implements."""
    monkeypatch.setattr(jax_interp, "FORCE_MATMUL", False)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_resample_fixed_matches_jax(seed):
    r = np.random.RandomState(seed)
    batch, t_pad, channels = 5, CFG.max_len_pad, 7
    x = r.randn(batch, t_pad, channels).astype(np.float32)
    # a full-length row (as the encoders call it), rows shorter than one
    # segment, and crop lengths of the collator's range
    len_seq = np.array([t_pad, 5, 12, r.randint(64, 129), r.randint(64, 129)],
                       np.int32)
    scales, len_seg = _draws(r, batch)
    want = jax_interp.resample_fixed(
        jnp.asarray(x), jnp.asarray(len_seq), jnp.asarray(scales),
        jnp.asarray(len_seg), max_len_pad=t_pad, seg_span=SPAN,
    )
    got = interp.resample_fixed(
        torch.from_numpy(x), torch.from_numpy(len_seq),
        torch.from_numpy(scales), torch.from_numpy(len_seg),
        max_len_pad=t_pad, seg_span=SPAN,
    )
    assert got.shape == (batch, t_pad, channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_resample_fixed_is_differentiable_in_x():
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(2, 64, 3).astype(np.float32))
    x.requires_grad_(True)
    scales, len_seg = _draws(r, 2)
    y = interp.resample_fixed(x, torch.tensor([64, 40]),
                              torch.from_numpy(scales),
                              torch.from_numpy(len_seg), max_len_pad=64,
                              seg_span=SPAN)
    (grad,) = torch.autograd.grad(y.sum(), x)
    # each output frame spreads weight 1 over its two source frames
    assert abs(float(grad.sum()) - 3 * float((y != 0).any(-1).sum())) < 1e-3


def test_random_resample_shape_tail_and_laws():
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(6, CFG.max_len_pad, 4) + 1.0  # no zero frames in
    len_seq = torch.tensor([40, 64, 80, 100, 128, 192])
    y = interp.random_resample(x, len_seq, gen, **LAWS)
    assert y.shape == x.shape
    nonzero = (y != 0).any(-1)
    for row, n_valid in zip(nonzero, nonzero.sum(-1)):
        # the valid frames are a prefix, the tail is exact zeros
        assert bool(row[:n_valid].all()) and not bool(row[n_valid:].any())
    # the 40-frame row cannot fill 192 frames even at scale 1.5
    assert int(nonzero[0].sum()) < CFG.max_len_pad
    scales, len_seg = interp.draw_segments(
        1000, torch.Generator().manual_seed(1),
        min_len_seg=CFG.min_len_seg, max_len_seg=CFG.max_len_seg,
        max_len_seq=CFG.max_len_seq,
    )
    assert scales.shape == len_seg.shape == (1000, NUM_SEG)
    assert 0.5 <= float(scales.min()) and float(scales.max()) < 1.5
    assert int(len_seg.min()) == CFG.min_len_seg
    assert int(len_seg.max()) == CFG.max_len_seg - 1


def test_random_resample_seeded_draws_and_eval_identity():
    x = torch.rand(3, CFG.max_len_pad, 2)
    len_seq = torch.tensor([100, 128, 192])

    def run(seed):
        return interp.random_resample(
            x, len_seq, torch.Generator().manual_seed(seed), **LAWS)

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert interp.random_resample(x, len_seq, None, train=False,
                                  **LAWS) is x
    with pytest.raises(ValueError, match="Generator"):
        interp.random_resample(x, len_seq, None, **LAWS)
