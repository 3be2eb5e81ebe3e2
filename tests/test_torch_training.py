"""The port's training slice against the JAX package's at a tiny config:
the train-mode forward, one generator step and one F0-converter step
(loss and every gradient), the Adam update, and what the port refuses.

JAX PRNG streams cannot be reproduced in torch, so the resampling draws
are injected: ``random_resample`` is replaced at its call sites in both
packages by a wrapper over ``resample_fixed`` that pops the next
pre-drawn ``(scales, len_seg)`` from a numpy list, so both see the same
draws in the same order. The JAX side runs its normal CPU path (the scan
LSTMs) with float32 residuals and Adam moments; the port's recurrences
run their plain versions inside its ``autograd.Function``s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechsplit_tpu.data.collator import Collator as JaxCollator
from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.models import encoders as jax_encoders
from speechsplit_tpu.ops import interp as jax_interp
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import jax_params_to_state_dict
from speechsplit_tpu_torch.models import encoders
from speechsplit_tpu_torch.ops import bilstm, interp, multi_bilstm
from speechsplit_tpu_torch.training import (
    create_train_state,
    make_f0_train_step,
    make_optimizer,
    make_train_step,
)
from speechsplit_tpu_torch.training import train_step
from tests.test_pallas_multilstm import _tiny_config

B = 4
F32 = dict(residual_dtype="float32", adam_mu_dtype="float32")
JCFG = _tiny_config().replace(**F32)
CFG = SpeechSplitConfig(**dataclasses.asdict(JCFG))
T = CFG.max_len_pad
NUM_SEG = CFG.max_len_seq // CFG.min_len_seg + 1
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def gather_form(monkeypatch):
    monkeypatch.setattr(jax_interp, "FORCE_MATMUL", False)


def _draws(seed, count):
    r = np.random.RandomState(seed)
    return [
        (r.uniform(0.5, 1.5, (B, NUM_SEG)).astype(np.float32),
         r.randint(CFG.min_len_seg, CFG.max_len_seg,
                   (B, NUM_SEG)).astype(np.int32))
        for _ in range(count)
    ]


def _inject(monkeypatch, draws):
    """Both packages' random_resample call sites pop the same draws."""
    jax_queue, port_queue = list(draws), list(draws)

    def jax_fake(x, len_seq, key, *, max_len_seg, max_len_pad, **_):
        scales, len_seg = jax_queue.pop(0)
        return jax_interp.resample_fixed(
            x, len_seq, jnp.asarray(scales), jnp.asarray(len_seg),
            max_len_pad=max_len_pad, seg_span=2 * max_len_seg)

    def port_fake(x, len_seq, generator, *, max_len_seg, max_len_pad, **_):
        assert isinstance(generator, torch.Generator)
        scales, len_seg = port_queue.pop(0)
        return interp.resample_fixed(
            x, len_seq, torch.from_numpy(scales), torch.from_numpy(len_seg),
            max_len_pad=max_len_pad, seg_span=2 * max_len_seg)

    monkeypatch.setattr(jax_train_step, "random_resample", jax_fake)
    monkeypatch.setattr(jax_encoders, "random_resample", jax_fake)
    monkeypatch.setattr(train_step, "random_resample", port_fake)
    monkeypatch.setattr(encoders, "random_resample", port_fake)
    return jax_queue, port_queue


def _batch(seed):
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(B):
        length = int(rng.integers(12, 60))  # some shorter than a crop
        mel = rng.random((length, CFG.dim_freq), dtype=np.float32)
        f0 = np.where(rng.random(length) < 0.3, 0.0,
                      rng.random(length)).astype(np.float32)
        samples.append((mel, np.eye(CFG.dim_spk_emb, dtype=np.float32)[i],
                        f0))
    return JaxCollator(JCFG)(samples, rng)


def _init(jmodel, *inputs):
    rngs = {"params": jax.random.PRNGKey(0), "resample": jax.random.PRNGKey(1)}
    return jmodel.init(rngs, *inputs)["params"]


def _port_state(name, params):
    state = create_train_state(CFG, 7, name, device="cpu")
    state.model.load_state_dict(jax_params_to_state_dict(params, name),
                                strict=True)
    return state


def _assert_grads(model, jgrads, name):
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), name)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        grad = got[key].grad.numpy()
        scale = float(np.abs(ref.numpy()).max())
        err = float(np.abs(grad - ref.numpy()).max())
        assert err <= 1e-4 * scale, (key, err, scale)


def test_train_forward_matches_jax(monkeypatch):
    rng = np.random.RandomState(3)
    x_f0 = rng.rand(B, T, CFG.dim_freq + CFG.dim_f0).astype(np.float32)
    x_org = rng.rand(B, T, CFG.dim_freq).astype(np.float32)
    c_trg = rng.rand(B, CFG.dim_spk_emb).astype(np.float32)
    jmodel = JaxSpeechSplit(JCFG)
    params = _init(jmodel, x_f0, x_org, c_trg)
    jq, pq = _inject(monkeypatch, _draws(3, 3))  # content/pitch convs 0-2
    want = jmodel.apply({"params": params}, x_f0, x_org, c_trg, train=True,
                        rngs={"resample": KEY})
    model = _port_state("speechsplit", params).model
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x_f0, x_org, c_trg)), train=True,
                    generator=torch.Generator())
    assert not jq and not pq
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    # train mode resamples: it differs from the eval forward
    with torch.no_grad():
        plain = model(*map(torch.from_numpy, (x_f0, x_org, c_trg)))
    assert float((plain - got).abs().max()) > 1e-3


def _jax_step(monkeypatch, make_step, jmodel, params, batch):
    """Run the JAX package's own train step once; return its loss and
    the gradients it hands its optimizer (recorded by an optimizer put
    in place of ``make_optimizer``)."""
    recorded = []

    def recording_optimizer(config):
        def update(grads, state, params=None):
            recorded.append(grads)
            return jax.tree.map(jnp.zeros_like, grads), state

        return optax.GradientTransformation(lambda p: (), update)

    monkeypatch.setattr(jax_train_step, "make_optimizer", recording_optimizer)
    state = jax_train_step.TrainState(params, (), jnp.zeros((), jnp.int32))
    _, loss = make_step(JCFG, jmodel)(state, batch, KEY)
    (grads,) = recorded
    return float(loss), grads


def test_generator_step_loss_and_grads_match_jax(monkeypatch):
    batch = _batch(0)
    jmodel = JaxSpeechSplit(JCFG)
    params = _init(jmodel, np.zeros((1, T, CFG.dim_freq + CFG.dim_f0)),
                   np.zeros((1, T, CFG.dim_freq)),
                   np.zeros((1, CFG.dim_spk_emb)))
    # the augmentation's draw, then content/pitch convs 0-2
    jq, pq = _inject(monkeypatch, _draws(10, 4))
    want_loss, jgrads = _jax_step(monkeypatch,
                                  jax_train_step.make_train_step_fn, jmodel,
                                  params, batch)
    state = _port_state("speechsplit", params)
    state, loss = make_train_step(CFG)(state, batch)
    assert not jq and not pq
    assert state.step == 1
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _assert_grads(state.model, jgrads, "speechsplit")
    assert not any(bilstm.LAUNCHES.values())
    assert not any(multi_bilstm.LAUNCHES.values())


def test_f0_converter_step_loss_and_grads_match_jax(monkeypatch):
    batch = _batch(1)
    jmodel = JaxF0Converter(JCFG)
    params = _init(jmodel, np.zeros((1, T, CFG.dim_freq)),
                   np.zeros((1, T, CFG.dim_f0)))
    jq, pq = _inject(monkeypatch, _draws(11, 3))  # f0 convs 0-2
    want_loss, jgrads = _jax_step(monkeypatch,
                                  jax_train_step.make_f0_train_step_fn,
                                  jmodel, params, batch)
    state = _port_state("f0_converter", params)
    state, loss = make_f0_train_step(CFG)(state, batch)
    assert not jq and not pq
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    _assert_grads(state.model, jgrads, "f0_converter")


def test_adam_updates_match_optax():
    rng = np.random.RandomState(5)
    shapes = [(4, 3), (7,), (2, 5, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 10.0 ** rng.randint(-3, 2)
              for s in shapes] for _ in range(3)]
    tx = jax_train_step.make_optimizer(JCFG)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(CFG, tparams)
    for step_grads in grads:
        updates, opt_state = tx.update([jnp.asarray(g) for g in step_grads],
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, step_grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, j in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       atol=1e-6, rtol=0)


def test_unported_settings_and_missing_generator_raise(monkeypatch):
    # bfloat16 residuals, Adam mu, gradients and compute train; a dtype
    # without a JAX counterpart is what raises
    for override in (dict(residual_dtype="bfloat16"),
                     dict(adam_mu_dtype="bfloat16"),
                     dict(grad_dtype="bfloat16"),
                     dict(compute_dtype="bfloat16")):
        ok = CFG.replace(**override)
        create_train_state(ok, 0, device="cpu")
        make_train_step(ok)
        make_optimizer(ok, [torch.nn.Parameter(torch.zeros(1))])
    bad = CFG.replace(compute_dtype="float16")
    with pytest.raises(ValueError, match="dtype"):
        create_train_state(bad, 0, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        make_train_step(bad)
    with pytest.raises(ValueError, match="dtype"):
        make_optimizer(bad, [torch.nn.Parameter(torch.zeros(1))])
    # learned speaker mode trains (tests/test_torch_learned_step.py); an
    # unknown mode raises
    learned = create_train_state(CFG.replace(spk_emb_mode="learned"), 0,
                                 device="cpu")
    assert hasattr(learned.model, "speaker_encoder")
    with pytest.raises(ValueError, match="spk_emb_mode"):
        create_train_state(CFG.replace(spk_emb_mode="xvector"), 0,
                           device="cpu")
    # the JAX defaults (bfloat16 residuals and Adam mu) train as they stand
    state = create_train_state(SpeechSplitConfig(), 0, device="cpu")
    assert state.optimizer.mu_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="model"):
        create_train_state(CFG, 0, "vocoder", device="cpu")
    model = create_train_state(CFG, 0, device="cpu").model
    x = torch.zeros(1, T, CFG.dim_freq + CFG.dim_f0)
    with pytest.raises(ValueError, match="Generator"):
        model(x, x[..., : CFG.dim_freq], torch.zeros(1, CFG.dim_spk_emb),
              train=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(CFG, 0)
