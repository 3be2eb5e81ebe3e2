"""The merged BiLSTM forwards' plain versions (``ops.bilstm``, CPU)
against the JAX package's ``_bd_infer`` and ``_bd_fwd`` Pallas kernels in
interpret mode, on the shapes the CUDA kernels of ``csrc/bilstm_infer.cu``
treat specially: a batch that leaves the last round of 8 rows ragged (1,
9, 28), widths that are not a multiple of 4 (the 4-byte copies), a
width between 129 and 256 (a partial 128-wide pass of the step product,
and two warps a unit), widths of at most 8 (one block a direction), and
short sequences. The kernels are held to these plain versions on the
card (``chip_smoke.check_merged_forward_edges``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.ops import bilstm
from tests.jax_interpret import at_test_fold

TOL = 1e-5  # float32 sums in another order, over at most 6 steps


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    at_test_fold(monkeypatch)
    pallas_lstm.FORCE_INTERPRET = True
    yield
    pallas_lstm.FORCE_INTERPRET = False


def _inputs(t, b, h):
    rng = np.random.RandomState(1000 * h + 10 * b + t)
    xp_f, xp_b = (rng.randn(t, b, 4 * h).astype(np.float32) for _ in "fb")
    # JAX w_hh is [H, 4H]; the port takes torch's [4H, H]
    w_f, w_b = ((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
                for _ in "fb")
    jax_args = [jnp.asarray(a) for a in (xp_f, xp_b, w_f, w_b)]
    torch_args = [torch.from_numpy(xp_f), torch.from_numpy(xp_b),
                  torch.from_numpy(w_f.T.copy()),
                  torch.from_numpy(w_b.T.copy())]
    return jax_args, torch_args


SHAPES = [(6, 1, 512), (3, 9, 8), (2, 28, 8), (5, 9, 6), (1, 28, 3),
          (4, 9, 132), (2, 28, 200), (1, 1, 1)]


@pytest.mark.parametrize("t,b,h", SHAPES)
def test_lean_forward_matches_bd_infer(t, b, h):
    jax_args, torch_args = _inputs(t, b, h)
    want = pallas_lstm._bd_infer(*jax_args)
    got = bilstm.bilstm_sequence_reference(*torch_args)
    for g, w in zip(got, want):
        assert g.shape == (t, b, h)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("t,b,h", SHAPES)
def test_residual_forward_matches_bd_fwd(t, b, h):
    jax_args, torch_args = _inputs(t, b, h)
    want = pallas_lstm._bd_fwd(*jax_args, residual_dtype=jnp.float32)
    got = bilstm.bilstm_forward_reference(*torch_args)
    shapes = [(t, b, h)] * 2 + [(t, b, 4 * h)] * 2 + [(t, b, h)] * 2
    for g, w, shape in zip(got, want, shapes):
        assert g.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("h,units", [(512, 8), (256, 4), (129, 4), (9, 4),
                                     (8, 8), (3, 3)])
def test_forward_plan_units_and_limits(h, units):
    """The source's plan: 4 units a block (two warps a unit) from H=9 to
    kSplitMaxH, else min(H, 8); the forward limits follow it, the
    residual-saving one 2 rows below the lean one (h and c a unit
    more in a row), and the
    autograd limit stays the gradient kernel's wherever it is lower."""
    assert bilstm._infer_units(h) == units
    lean = bilstm.forward_max_batch(h, resid=False)
    fwd = bilstm.forward_max_batch(h, resid=True)
    assert lean == bilstm.merged_max_batch(h)
    assert fwd == lean - 2
    assert bilstm.merged_max_batch(h, grad=True) <= fwd
