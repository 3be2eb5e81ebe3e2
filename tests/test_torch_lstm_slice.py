"""The single-direction route end to end at a tiny config: with
``merged_bidir_fits`` patched to False in both packages, every merged
BiLSTM layer runs one ``lstm_sequence`` per direction. The generator's
eval forward, ``convert_batched``, and one generator and one F0-converter
train step, against the JAX package on the same numpy-seeded inputs and
weights (the resampling draws injected into both, as in
test_torch_training.py). Each test also counts the port's calls, so that
every such layer is seen to take the single-direction route and none the
merged one."""

import jax
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
from speechsplit_tpu_torch.ops import bilstm, lstm
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
def single_direction(monkeypatch):
    monkeypatch.setattr(bilstm, "merged_bidir_fits",
                        lambda *args, **kwargs: False)
    monkeypatch.setattr(pallas_lstm, "merged_bidir_fits",
                        lambda *args, **kwargs: False)
    monkeypatch.setattr(jax_interp, "FORCE_MATMUL", False)


@pytest.fixture
def routes(monkeypatch):
    """The port's calls of each route: ``lstm.lstm_sequence`` (the batch
    of each call, and whether autograd recorded it) and the merged ops;
    and the gradient recurrences the single-direction route ran."""
    calls = {"single": [], "merged": [], "single_bwd": 0}
    real = lstm.lstm_sequence

    def single(xp, w, reverse=False, residual_dtype=torch.float32):
        calls["single"].append((xp.shape[1], reverse, xp.requires_grad))
        return real(xp, w, reverse, residual_dtype)

    def merged(*args):
        calls["merged"].append(tuple(args[0].shape))
        raise AssertionError("the merged route ran")

    real_bwd = lstm.lstm_direction_backward_reference

    def single_bwd(*args):
        calls["single_bwd"] += 1
        return real_bwd(*args)

    monkeypatch.setattr(lstm, "lstm_sequence", single)
    monkeypatch.setattr(lstm, "lstm_direction_backward_reference", single_bwd)
    for name in ("bilstm_sequence", "bilstm_sequence_fused"):
        monkeypatch.setattr(bilstm, name, merged)
    return calls


def test_generator_eval_forward_matches_jax(rng, monkeypatch, routes):
    """B=8: JAX takes its Pallas single-direction kernels too (interpret
    mode), so they are on the JAX side of the comparison."""
    from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.interop import jax_params_to_state_dict

    monkeypatch.setattr(pallas_lstm, "FORCE_INTERPRET", True)
    at_test_fold(monkeypatch)
    jcfg, cfg = JaxConfig(**TINY), SpeechSplitConfig(**TINY)
    b, t = 8, cfg.max_len_pad
    x_f0 = rng.rand(b, t, cfg.dim_freq + cfg.dim_f0).astype(np.float32)
    x_org = rng.rand(b, t, cfg.dim_freq).astype(np.float32)
    c_trg = rng.rand(b, cfg.dim_spk_emb).astype(np.float32)
    jmodel = JaxSpeechSplit(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, x_f0, x_org,
                         c_trg)["params"]
    jax_calls = []
    real_jax = pallas_lstm.lstm_sequence

    def jax_single(*args):
        jax_calls.append(args[3])
        return real_jax(*args)

    monkeypatch.setattr(pallas_lstm, "lstm_sequence", jax_single)
    want = np.asarray(jmodel.apply({"params": params}, x_f0, x_org, c_trg))
    model = SpeechSplit(cfg, torch.Generator()).eval()
    model.load_state_dict(jax_params_to_state_dict(params, "speechsplit"),
                          strict=True)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x_f0, x_org, c_trg)))
    # the mel decoder's three layers and content layer 1, two directions
    # each, in both packages
    assert routes["single"] == [(b, False, False), (b, True, False)] * 4
    assert sorted(jax_calls) == [False] * 4 + [True] * 4
    assert not routes["merged"]
    np.testing.assert_allclose(got.numpy(), want, atol=FORWARD_ATOL)
    assert not any(lstm.LAUNCHES.values())


def test_convert_batched_matches_jax(models, routes):  # noqa: F811
    (jg, g_params, jp, p_params), (g, p) = models
    jax_pairs, port_pairs = _pairs([(30, 25), (20, 32)])
    want = jconvert.convert_batched(jg, g_params, jp, p_params, jax_pairs)
    got = tconvert.convert_batched(g, p, port_pairs)
    # the F0 decoder's 2 layers at batch 2, the generator's 4 at 7 x 2
    assert sorted(b for b, _, _ in routes["single"]) == [2] * 4 + [14] * 8
    assert not routes["merged"]
    for got_pair, want_pair in zip(got, want):
        for (name, a), (_, w) in zip(got_pair, want_pair):
            np.testing.assert_allclose(a, np.asarray(w), atol=FORWARD_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("model,n_layers", [("speechsplit", 4),
                                            ("f0_converter", 2)])
def test_train_step_matches_jax(monkeypatch, routes, model, n_layers):
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
    state, loss = make(CFG)(state, batch)
    assert not jq and not pq
    # every merged layer's two directions, under autograd, and their
    # gradient recurrences
    assert len(routes["single"]) == 2 * n_layers
    assert all(recorded for _, _, recorded in routes["single"])
    assert routes["single_bwd"] == 2 * n_layers
    assert not routes["merged"]
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads(state.model, jgrads, model)
    assert not any(lstm.LAUNCHES.values())
