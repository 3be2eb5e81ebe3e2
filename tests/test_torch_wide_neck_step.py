"""The default config's train step with a wide pitch bottleneck
(``dim_neck_3``) against the JAX package's: 40, where the F0 and pitch
streams run the multi-stream kernels' block plans at bfloat16 residuals,
and 72, past their ``MAX_HIDDEN``, where each encoder runs its own layer
(JAX still runs its multi-stream kernel: its ``fits`` is a VMEM budget
with no width limit). The SpeechSplit step at 40 here; at 72, and the
F0 converter's at both, in tests/test_torch_wide_neck_f0.py (the two
files take about a minute each on one worker).

As tests/test_torch_precision.py holds the default widths: JAX's own
step at ``_tiny_config()`` (bfloat16 residuals and Adam mu) with its
Pallas kernels in interpret mode at B=8 (``TEST_FOLD``), the resampling
draws injected into both packages; the loss within 1e-5 relative, every
gradient within 2% max-relative (PARITY.md #10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu_torch.interop import jax_params_to_state_dict
from speechsplit_tpu_torch.ops import bilstm, multi_bilstm
from speechsplit_tpu_torch.training import (
    create_train_state,
    make_f0_train_step,
    make_train_step,
)
from tests.test_torch_compute_bf16 import interpret
from tests.test_torch_precision import GRAD_TOL, LOSS_RTOL, _batch8, _draws
from tests.test_torch_training import (  # noqa: F401 (gather_form: autouse)
    KEY,
    _init,
    _inject,
    gather_form,
)
from tests.test_torch_wide_neck import configs, count_routes

@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _jax_grads(monkeypatch, make_step, jcfg, jmodel, params, batch):
    """JAX's own train step once at ``jcfg``: its loss and the gradients
    it hands its optimizer."""
    recorded = []

    def recording_optimizer(config):
        def update(grads, state, params=None):
            recorded.append(grads)
            return jax.tree.map(jnp.zeros_like, grads), state

        return optax.GradientTransformation(lambda p: (), update)

    monkeypatch.setattr(jax_train_step, "make_optimizer", recording_optimizer)
    state = jax_train_step.TrainState(params, (), jnp.zeros((), jnp.int32))
    _, loss = make_step(jcfg, jmodel)(state, batch, KEY)
    (grads,) = recorded
    return float(loss), grads


def check_wide_step(monkeypatch, name: str, neck: int) -> None:
    """One default-config step of model ``name`` at ``dim_neck_3=neck``
    against JAX's, and the routes it took (``ROUTES`` of
    tests/test_torch_wide_neck.py, under autograd)."""
    jcfg, cfg = configs(neck)
    t = cfg.max_len_pad
    if name == "speechsplit":
        jmodel = JaxSpeechSplit(jcfg)
        params = _init(jmodel, np.zeros((1, t, cfg.dim_freq + cfg.dim_f0)),
                       np.zeros((1, t, cfg.dim_freq)),
                       np.zeros((1, cfg.dim_spk_emb)))
        make_jax, make_port = (jax_train_step.make_train_step_fn,
                               make_train_step)
        draws = _draws(20 + neck, 4)
    else:
        jmodel = JaxF0Converter(jcfg)
        params = _init(jmodel, np.zeros((1, t, cfg.dim_freq)),
                       np.zeros((1, t, cfg.dim_f0)))
        make_jax, make_port = (jax_train_step.make_f0_train_step_fn,
                               make_f0_train_step)
        draws = _draws(21 + neck, 3)
    batch = _batch8(5)
    jq, pq = _inject(monkeypatch, draws)
    want_loss, jgrads = _jax_grads(monkeypatch, make_jax, jcfg, jmodel,
                                   params, batch)
    state = create_train_state(cfg, 7, name, device="cpu")
    state.model.load_state_dict(jax_params_to_state_dict(params, name),
                                strict=True)
    counts = count_routes(monkeypatch)
    state, loss = make_port(cfg)(state, batch)
    assert not jq and not pq
    wide = neck > multi_bilstm.MAX_HIDDEN
    assert (counts["multi_bilstm_sequence"] == 0) == wide, counts
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), name)
    got = dict(state.model.named_parameters())
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        err = float((got[key].grad - ref).abs().max())
        assert err <= GRAD_TOL * float(ref.abs().max()), (key, err)
    assert not any(bilstm.LAUNCHES.values())
    assert not any(multi_bilstm.LAUNCHES.values())


@pytest.mark.parametrize("neck", [40])
def test_generator_step_matches_jax(monkeypatch, neck):
    check_wide_step(monkeypatch, "speechsplit", neck)
