"""Learned speaker mode through training: one generator step with the
contrastive weight at 0 and at 0.1 against JAX's own step, ``Solver.
validate()`` against JAX's, and learned checkpoints (save, resume).

The steps run at a tiny config with a 32-frame window, B=4, float32
residuals and Adam moments: JAX takes its scan path there (no Pallas).
The resampling draws are injected into both packages
(tests/test_torch_training.py). The batch holds two rows of one speaker
and two speakers alone, so the contrastive term has anchors with a
positive and anchors without one. Bars: the loss within 1e-5 relative,
every gradient (the SpeakerEncoder's included) within 1e-4 of its
largest magnitude, the float32 bars of tests/test_torch_training.py
(tighter than PARITY.md #10's 2%, which is bfloat16 residuals'); the
validation mels within 5e-5 (PARITY.md's conversion bar).
"""

import dataclasses
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechsplit_tpu.data.collator import Collator as JaxCollator
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu.training.solver import Solver as JaxSolver
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import (
    jax_params_to_state_dict,
    load_reference_checkpoint,
)
from speechsplit_tpu_torch.models import SpeechSplit
from speechsplit_tpu_torch.ops import bilstm, multi_bilstm
from speechsplit_tpu_torch.parallel import Mesh
from speechsplit_tpu_torch.training import (
    Solver,
    SolverConfig,
    create_train_state,
    make_train_step,
)
from speechsplit_tpu_torch.training import checkpoint as ckpt_lib
from speechsplit_tpu_torch.training.train_step import (
    _speaker_conditioning,
    speaker_contrastive_loss,
)
from tests.test_torch_speaker_encoder import jax_learned_params
from tests.test_torch_training import (  # noqa: F401 (gather_form: autouse)
    KEY,
    _draws,
    _inject,
    gather_form,
)
from tests.test_pallas_multilstm import _tiny_config

JCFG = _tiny_config().replace(
    spk_emb_mode="learned", dim_spk_enc=32, residual_dtype="float32",
    adam_mu_dtype="float32")
CFG = SpeechSplitConfig(**dataclasses.asdict(JCFG))
T = CFG.max_len_pad
SPEAKERS = (5, 5, 11, 40)  # rows 0 and 1 share a speaker
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
VAL_ATOL = 5e-5


def learned_batch(seed, speakers=SPEAKERS):
    rng = np.random.default_rng(seed)
    samples = []
    for spk in speakers:
        length = int(rng.integers(12, 60))  # some shorter than a crop
        mel = rng.random((length, CFG.dim_freq), dtype=np.float32)
        f0 = np.where(rng.random(length) < 0.3, 0.0,
                      rng.random(length)).astype(np.float32)
        samples.append((mel, np.eye(CFG.dim_spk_emb, dtype=np.float32)[spk],
                        f0))
    return JaxCollator(JCFG)(samples, rng)


def _jax_step(monkeypatch, config, params, batch):
    """JAX's own generator step once, jitted: its loss and the gradients
    it hands its optimizer (an optimizer put in place of
    ``make_optimizer`` keeps them as its state)."""
    def keeping_optimizer(cfg):
        return optax.GradientTransformation(
            lambda p: jax.tree.map(jnp.zeros_like, p),
            lambda grads, state, params=None: (
                jax.tree.map(jnp.zeros_like, grads), grads))

    monkeypatch.setattr(jax_train_step, "make_optimizer", keeping_optimizer)
    state = jax_train_step.TrainState(
        params, jax.tree.map(jnp.zeros_like, params), jnp.zeros((), jnp.int32))
    step = jax_train_step.make_train_step_fn(config, JaxSpeechSplit(config))
    state, loss = jax.jit(step)(state, batch, KEY)
    return float(loss), state.opt_state


@pytest.fixture(scope="module")
def params():
    """One learned tree for every test (the weight does not shape it)."""
    return jax_learned_params(JCFG)


@pytest.mark.parametrize("weight", [0.0, 0.1])
def test_learned_step_matches_jax(monkeypatch, params, weight):
    jcfg = JCFG.replace(spk_contrast_weight=weight)
    cfg = CFG.replace(spk_contrast_weight=weight)
    batch = learned_batch(0)
    # the augmentation's draw, then content/pitch convs 0-2
    jq, pq = _inject(monkeypatch, _draws(20, 4))
    want_loss, jgrads = _jax_step(monkeypatch, jcfg, params, batch)
    state = create_train_state(cfg, 7, device="cpu")
    state.model.load_state_dict(jax_params_to_state_dict(params),
                                strict=True)
    state, loss = make_train_step(cfg)(state, batch)
    assert not jq and not pq
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads))
    got = dict(state.model.named_parameters())
    assert sorted(got) == sorted(want)
    assert any(k.startswith("speaker_encoder.") for k in got)
    for key, ref in want.items():
        err = float((got[key].grad - ref).abs().max())
        assert err <= GRAD_TOL * float(ref.abs().max()), (key, err)
    assert not any(bilstm.LAUNCHES.values())
    assert not any(multi_bilstm.LAUNCHES.values())
    # the conditioning: the batch's own mel, or its embedding and the
    # weighted contrastive term (anchors 2 and 3 have no positive)
    with torch.no_grad():
        mel = torch.from_numpy(np.asarray(batch.mel))
        tb = batch._replace(mel=mel,
                            spk_emb=torch.from_numpy(np.asarray(batch.spk_emb)))
        c_trg, aux = _speaker_conditioning(cfg, state.model, tb)
    if weight:
        assert c_trg.shape == (4, cfg.dim_spk_emb)
        term = speaker_contrastive_loss(c_trg, torch.tensor(SPEAKERS))
        assert float(term) > 0 and float(aux) == pytest.approx(
            weight * float(term), rel=1e-6)
    else:
        assert aux is None and c_trg is tb.mel
    # the global batch's term over a process group's mesh
    # (tests/test_torch_parallel.py); with no group, there is none
    with pytest.raises(RuntimeError, match="process group"):
        _speaker_conditioning(cfg, state.model, tb,
                              gather_axis=Mesh(size=2, rank=0))


def _val_demo(path):
    rng = np.random.RandomState(9)
    entries = []
    for i, length in enumerate((20, 31)):
        emb = np.zeros((1, CFG.dim_spk_emb), np.float32)
        emb[0, 2 + i] = 1.0
        mel = rng.rand(length, CFG.dim_freq).astype(np.float32)
        f0 = np.where(rng.rand(length) < 0.2, 0.0, rng.rand(length))
        entries.append([f"p{i}", emb, (mel, f0, length, f"00{i}")])
    with open(path, "wb") as handle:
        pickle.dump(entries, handle)


def test_validate_matches_jax(tmp_path, params):
    """``Solver.validate()`` in learned mode conditions on each
    utterance's padded mel, as JAX's (solver.py:289-296): the port's
    inputs equal JAX's ``_prepare_val_inputs``, its mels and its mean
    sum-MSE match JAX's eval forward on them."""
    demo = str(tmp_path / "demo.pkl")
    _val_demo(demo)
    solver = Solver(None, SolverConfig(model_save_dir=str(tmp_path / "t"),
                                       validation_path=demo), CFG,
                    device="cpu")
    solver.state.model.load_state_dict(jax_params_to_state_dict(params),
                                       strict=True)
    jax_eval = jax.jit(JaxSpeechSplit(JCFG).apply)
    kept, losses = [], []
    solver._eval = lambda *inputs: kept.append(
        Solver._eval(solver, *inputs)) or kept[-1]
    got_value = solver.validate()
    for sub, got in zip(solver.validation_pt, kept):
        inputs = JaxSolver._prepare_val_inputs(
            types.SimpleNamespace(config=JCFG), sub)
        mine = solver._prepare_val_inputs(sub)
        for a, b in zip(mine, inputs):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(inputs[2], inputs[1])
        want = np.asarray(jax_eval({"params": params}, *inputs))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VAL_ATOL)
        losses.append(float(np.sum(np.square(inputs[1] - want))))
    assert len(kept) == 2
    np.testing.assert_allclose(got_value, np.mean(losses), rtol=1e-5)


def _loader(seed):
    while True:
        yield learned_batch(seed)
        seed += 1


def test_learned_checkpoints_save_and_resume(tmp_path):
    """Four steps in one run equal two, a save, and two resumed; the
    learned .ckpt loads strictly into a learned model only."""
    cfg = CFG.replace(spk_contrast_weight=0.1)

    def run(save_dir, iters, resume=None):
        rc = SolverConfig(num_iters=iters, resume_iters=resume,
                          model_save_dir=str(save_dir), model_save_step=2,
                          log_step=2, sample_step=1000,
                          sample_dir=str(tmp_path / "s"),
                          validation_path=str(tmp_path / "none.pkl"))
        return Solver(_loader(0 if resume is None else 2), rc, cfg,
                      device="cpu").train()

    straight = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    resumed = run(tmp_path / "b", 2, resume=2)
    for (key, p), q in zip(straight.model.named_parameters(),
                           resumed.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=key)
    path = ckpt_lib.checkpoint_path(str(tmp_path / "a"), 4, "G")
    sd = load_reference_checkpoint(path)
    SpeechSplit(cfg).load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError, match="speaker_encoder"):
        SpeechSplit(cfg.replace(spk_emb_mode="onehot")).load_state_dict(
            sd, strict=True)
    assert os.path.exists(path)
