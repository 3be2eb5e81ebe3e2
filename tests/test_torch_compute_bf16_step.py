"""bfloat16 compute through a train step: the generator's step at
``compute_dtype="bfloat16"`` (bfloat16 residuals and Adam mu, the JAX
defaults otherwise) against JAX's own step, at ``_tiny_config()``'s
widths and B=8, the resampling draws injected into both packages.

JAX runs its Pallas kernels in interpret mode (B >= 8 takes them, and
the fused multi-stream path, as on the TPU). Bars:
- the loss within 1e-4 relative of JAX's bfloat16 loss (LOSS_RTOL), and
  within a quarter of JAX's own distance between its bfloat16 loss and
  its float32-compute loss on the same batch and weights (QUARTER): the
  port rounds where JAX rounds, not merely stays near float32;
- every gradient within 2% max-relative of JAX's bfloat16 gradients
  (PARITY.md #10's bar, GRAD_TOL).

JAX's float32-compute loss runs its scan path (no Pallas): at float32
compute the forward rounds nothing, so it is the Pallas path's loss to
float32 noise, in a sixth of the time. JAX compiling its bfloat16 step
in interpret mode still takes most of a minute (about 66 s for the
generator's and 49 s for the F0 converter's, on one CPU core).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu.ops.quantize import quantize_f0, quantize_f0_onehot
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu_torch.interop import jax_params_to_state_dict
from speechsplit_tpu_torch.ops import bilstm, multi_bilstm
from speechsplit_tpu_torch.training import (
    create_train_state,
    make_f0_train_step,
    make_train_step,
)
from tests.test_torch_compute_bf16 import interpret
from tests.test_torch_precision import DEF, JDEF, T, _batch8, _draws, _jax_step
from tests.test_torch_training import (  # noqa: F401 (gather_form: autouse)
    KEY,
    _inject,
    gather_form,
)

JBF = JDEF.replace(compute_dtype="bfloat16")
BF = DEF.replace(compute_dtype="bfloat16")
LOSS_RTOL = 1e-4
QUARTER = 0.25
GRAD_TOL = 0.02


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _init(jmodel, *inputs):
    """``tests.test_torch_training._init`` under ``jax.jit``: the same
    parameters, in half the time of the eager init."""
    rngs = {"params": jax.random.PRNGKey(0), "resample": jax.random.PRNGKey(1)}
    return jax.jit(jmodel.init)(rngs, *inputs)["params"]


def _jax_loss(name, config, params, batch):
    """JAX's train-step loss at ``config``'s compute dtype, the forward
    alone (``loss_fn`` of train_step.py:241-272 and :358-381; the draws
    injected)."""
    dtype = jnp.bfloat16 if config.compute_dtype == "bfloat16" else (
        jnp.float32)
    batch = jax_train_step._upcast_batch(batch)
    if name == "speechsplit":
        x_in = jax_train_step._augment_inputs(config, batch, KEY)
        out = JaxSpeechSplit(config, dtype=dtype).apply(
            {"params": params}, x_in, batch.mel, batch.spk_emb, train=True,
            rngs={"resample": KEY})
        return float(jnp.mean(jnp.square(batch.mel - out)))
    f0 = batch.f0[:, :, 0]
    logits = JaxF0Converter(config, dtype=dtype).apply(
        {"params": params}, batch.mel,
        quantize_f0_onehot(f0, config.dim_f0 - 1), train=True,
        rngs={"resample": KEY})
    losses = optax.softmax_cross_entropy_with_integer_labels(
        logits, quantize_f0(f0, config.dim_f0 - 1))
    valid = (jnp.arange(losses.shape[1])[None, :]
             < batch.len_org[:, None]).astype(losses.dtype)
    return float(jnp.sum(losses * valid) / jnp.maximum(jnp.sum(valid), 1.0))


def check_bf16_step(monkeypatch, name):
    """One step of ``name`` at bfloat16 compute against JAX's (the bars
    of the module docstring)."""
    if name == "speechsplit":
        jmodel = JaxSpeechSplit(JBF, dtype=jnp.bfloat16)
        params = _init(jmodel, np.zeros((1, T, DEF.dim_freq + DEF.dim_f0)),
                       np.zeros((1, T, DEF.dim_freq)),
                       np.zeros((1, DEF.dim_spk_emb)))
        make_jax, make_port = (jax_train_step.make_train_step_fn,
                               make_train_step)
        draws = _draws(30, 4)  # the augmentation, content/pitch convs 0-2
    else:
        jmodel = JaxF0Converter(JBF, dtype=jnp.bfloat16)
        params = _init(jmodel, np.zeros((1, T, DEF.dim_freq)),
                       np.zeros((1, T, DEF.dim_f0)))
        make_jax, make_port = (jax_train_step.make_f0_train_step_fn,
                               make_f0_train_step)
        draws = _draws(31, 3)  # f0 convs 0-2
    batch = _batch8(6)
    _inject(monkeypatch, draws)
    want_loss, jgrads = _jax_step(monkeypatch, make_jax, jmodel, params,
                                  batch)
    _inject(monkeypatch, draws)
    monkeypatch.setattr(pallas_lstm, "FORCE_INTERPRET", False)
    loss32 = _jax_loss(name, JDEF, params, batch)
    monkeypatch.setattr(pallas_lstm, "FORCE_INTERPRET", True)
    jq, pq = _inject(monkeypatch, draws)
    state = create_train_state(BF, 7, name, device="cpu")
    state.model.load_state_dict(jax_params_to_state_dict(params, name),
                                strict=True)
    state, loss = make_port(BF)(state, batch)
    assert not pq
    ours, theirs = abs(float(loss) - want_loss), abs(loss32 - want_loss)
    assert theirs > 0
    assert ours <= LOSS_RTOL * abs(want_loss), (ours, want_loss)
    assert ours <= QUARTER * theirs, (ours, theirs)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), name)
    got = dict(state.model.named_parameters())
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        err = float((got[key].grad - ref).abs().max())
        assert err <= GRAD_TOL * float(ref.abs().max()), (key, err)
    assert not any(bilstm.LAUNCHES.values())
    assert not any(multi_bilstm.LAUNCHES.values())


def test_generator_step_bf16_matches_jax(monkeypatch):
    check_bf16_step(monkeypatch, "speechsplit")
