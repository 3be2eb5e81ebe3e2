"""The fused-projection slice end to end at a tiny config, with
``ops.bilstm.PROJ_FUSION = "auto"`` in the port: the generator's eval
forward, ``convert_batched``, and one generator and one F0-converter
train step, against the JAX package on the same numpy-seeded inputs and
weights (the resampling draws injected into both, as in
test_torch_training.py). Each test also counts the port's calls, so
that every merged BiLSTM layer is seen to take the fused route and none
the composed one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu import convert as jconvert
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.ops import interp as jax_interp
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu_torch import convert as tconvert
from speechsplit_tpu_torch.models import SpeechSplit
from speechsplit_tpu_torch.ops import bilstm
from speechsplit_tpu_torch.training import make_f0_train_step, make_train_step
from tests.jax_interpret import at_test_fold
from tests.test_torch_convert import _pairs, models  # noqa: F401
from tests.test_torch_models import TINY
from tests.test_torch_training import (
    CFG,
    JCFG,
    _assert_grads,
    _batch,
    _draws,
    _init,
    _inject,
    _jax_step,
    _port_state,
)

FORWARD_ATOL = 5e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def fusion_on(monkeypatch):
    monkeypatch.setattr(bilstm, "PROJ_FUSION", "auto")
    monkeypatch.setattr(pallas_lstm, "PROJ_FUSION", "auto")
    monkeypatch.setattr(pallas_lstm, "RESIDUAL_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_interp, "FORCE_MATMUL", False)


def _count(monkeypatch, name):
    """Count the calls of ``ops.bilstm.<name>`` (looked up at call time
    by the port's layers and Functions)."""
    calls = []
    real = getattr(bilstm, name)

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(bilstm, name, counted)
    return calls


def test_generator_eval_forward_matches_jax(rng, monkeypatch):
    """B=8: JAX fuses too (interpret mode), so the Pallas fused kernel is
    on the JAX side of the comparison."""
    from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.interop import jax_params_to_state_dict

    monkeypatch.setattr(pallas_lstm, "FORCE_INTERPRET", True)
    at_test_fold(monkeypatch)
    jcfg, cfg = JaxConfig(**TINY), SpeechSplitConfig(**TINY)
    b, t = 8, cfg.max_len_pad
    assert pallas_lstm.fused_proj_plan(t, b, cfg.dim_dec_mel, cfg.dim_code,
                                       jnp.float32)
    x_f0 = rng.rand(b, t, cfg.dim_freq + cfg.dim_f0).astype(np.float32)
    x_org = rng.rand(b, t, cfg.dim_freq).astype(np.float32)
    c_trg = rng.rand(b, cfg.dim_spk_emb).astype(np.float32)
    jmodel = JaxSpeechSplit(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, x_f0, x_org,
                         c_trg)["params"]
    want = np.asarray(jmodel.apply({"params": params}, x_f0, x_org, c_trg))
    model = SpeechSplit(cfg, torch.Generator()).eval()
    model.load_state_dict(jax_params_to_state_dict(params, "speechsplit"),
                          strict=True)
    fused = _count(monkeypatch, "bilstm_sequence_fused_reference")
    composed = _count(monkeypatch, "bilstm_sequence")
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x_f0, x_org, c_trg)))
    # the mel decoder's three layers and content layer 1
    assert len(fused) == 4 and not composed
    np.testing.assert_allclose(got.numpy(), want, atol=FORWARD_ATOL)
    assert not any(bilstm.LAUNCHES.values())


def test_convert_batched_matches_jax(models, monkeypatch):  # noqa: F811
    """Generator batch 7 x 2 = 14: the port fuses where JAX's plan
    refuses (B % 8), with the same conversions."""
    (jg, g_params, jp, p_params), (g, p) = models
    jax_pairs, port_pairs = _pairs([(30, 25), (20, 32)])
    want = jconvert.convert_batched(jg, g_params, jp, p_params, jax_pairs)
    fused = _count(monkeypatch, "bilstm_sequence_fused_reference")
    composed = _count(monkeypatch, "bilstm_sequence")
    got = tconvert.convert_batched(g, p, port_pairs)
    # 4 generator layers at batch 14 and the F0 decoder's 2 at batch 2
    assert sorted(s[1] for s in fused) == [2, 2, 14, 14, 14, 14]
    assert not composed
    for got_pair, want_pair in zip(got, want):
        for (name, a), (_, w) in zip(got_pair, want_pair):
            np.testing.assert_allclose(a, np.asarray(w), atol=FORWARD_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("model,n_layers", [("speechsplit", 4),
                                            ("f0_converter", 2)])
def test_train_step_matches_jax(monkeypatch, model, n_layers):
    from speechsplit_tpu.models import F0Converter as JaxF0Converter

    t = CFG.max_len_pad
    if model == "speechsplit":
        jmodel = JaxSpeechSplit(JCFG)
        params = _init(jmodel, np.zeros((1, t, CFG.dim_freq + CFG.dim_f0)),
                       np.zeros((1, t, CFG.dim_freq)),
                       np.zeros((1, CFG.dim_spk_emb)))
        draws, jax_make, make = (_draws(10, 4),
                                 jax_train_step.make_train_step_fn,
                                 make_train_step)
    else:
        jmodel = JaxF0Converter(JCFG)
        params = _init(jmodel, np.zeros((1, t, CFG.dim_freq)),
                       np.zeros((1, t, CFG.dim_f0)))
        draws, jax_make, make = (_draws(11, 3),
                                 jax_train_step.make_f0_train_step_fn,
                                 make_f0_train_step)
    batch = _batch(0 if model == "speechsplit" else 1)
    jq, pq = _inject(monkeypatch, draws)
    want_loss, jgrads = _jax_step(monkeypatch, jax_make, jmodel, params,
                                  batch)
    state = _port_state(model, params)
    fused = _count(monkeypatch, "bilstm_fused_forward_reference")
    composed = _count(monkeypatch, "bilstm_sequence")
    state, loss = make(CFG)(state, batch)
    assert not jq and not pq
    assert len(fused) == n_layers and not composed
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads(state.model, jgrads, model)
    assert not any(bilstm.LAUNCHES.values())
