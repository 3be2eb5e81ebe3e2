"""The JAX default train step's precision in the port, against the JAX
package at a tiny config: bfloat16 residuals through whole train steps,
Adam with a bfloat16 mu (and bfloat16 gradients), ``matmul_precision``,
the Adam state carried over from JAX with a bfloat16 mu, and save and
resume of a bfloat16-mu run.

The train steps are ``SpeechSplitConfig``'s defaults (bfloat16 residuals
and Adam mu, ``matmul_precision="default"``) at ``_tiny_config()``'s
widths, B=8: JAX runs its Pallas kernels in interpret mode there (below
8 rows it takes its scan path, which rounds nothing). The resampling
draws are injected into both packages, as in ``test_torch_training.py``.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speechsplit_tpu.data.collator import Collator as JaxCollator
from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu_torch.cli import train as cli_train
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import (
    jax_adam_state_to_torch,
    jax_params_to_state_dict,
)
from speechsplit_tpu_torch.ops import bilstm, multi_bilstm
from speechsplit_tpu_torch.training import (
    Solver,
    create_train_state,
    make_f0_train_step,
    make_optimizer,
    make_train_step,
)
from speechsplit_tpu_torch.training import train_step
from speechsplit_tpu_torch.training import checkpoint as ckpt_lib
from tests.jax_interpret import interpret
from tests.test_pallas_multilstm import _tiny_config
from tests.test_torch_data import write_feature_tree
from tests.test_torch_residual_bf16 import assert_within_one_ulp
from tests.test_torch_solver import _run_config, _snapshot
from tests.test_torch_training import (  # noqa: F401 (gather_form: autouse)
    CFG,
    JCFG,
    KEY,
    _batch,
    _init,
    _inject,
    gather_form,
)

B = 8
# the JAX defaults (bfloat16 residuals and Adam mu) at tiny widths
JDEF = _tiny_config()
DEF = SpeechSplitConfig(**dataclasses.asdict(JDEF))
T = DEF.max_len_pad
NUM_SEG = DEF.max_len_seq // DEF.min_len_seg + 1
# a train step against JAX's: the loss relative; each gradient's max abs
# error over its max abs (PARITY.md #10: bf16 residuals move gradients
# by at most 2% max-relative)
LOSS_RTOL = 1e-5
GRAD_TOL = 0.02
# Adam against optax: the parameters, absolute
ADAM_ATOL = 1e-6


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


@pytest.fixture()
def one_torch_thread():
    """One torch thread: the port's plain loops are many small ops, and
    with torch's intra-op threads contending with the other test
    processes for the cores they run many times slower. No check reads
    the thread count: a run is compared with another at the same count,
    or with JAX within its stated bar."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_default_config_is_bfloat16():
    assert (DEF.residual_dtype, DEF.adam_mu_dtype, DEF.grad_dtype,
            DEF.matmul_precision) == ("bfloat16", "bfloat16", "float32",
                                      "default")
    model = create_train_state(DEF, 0, device="cpu").model
    assert model.decoder.lstm.residual_dtype == torch.bfloat16
    assert model.encoder_1.lstm_1.residual_dtype == torch.bfloat16


def _draws(seed, count):
    r = np.random.RandomState(seed)
    return [
        (r.uniform(0.5, 1.5, (B, NUM_SEG)).astype(np.float32),
         r.randint(DEF.min_len_seg, DEF.max_len_seg,
                   (B, NUM_SEG)).astype(np.int32))
        for _ in range(count)
    ]


def _batch8(seed):
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(B):
        length = int(rng.integers(12, 60))
        mel = rng.random((length, DEF.dim_freq), dtype=np.float32)
        f0 = np.where(rng.random(length) < 0.3, 0.0,
                      rng.random(length)).astype(np.float32)
        samples.append((mel, np.eye(DEF.dim_spk_emb, dtype=np.float32)[i],
                        f0))
    return JaxCollator(JDEF)(samples, rng)


@functools.cache
def _jax_model(name):
    """JAX's model at the default config and its initial params, once a
    model for the module (immutable arrays; every test starts from
    them)."""
    if name == "speechsplit":
        jmodel = JaxSpeechSplit(JDEF)
        return jmodel, _init(jmodel,
                             np.zeros((1, T, DEF.dim_freq + DEF.dim_f0)),
                             np.zeros((1, T, DEF.dim_freq)),
                             np.zeros((1, DEF.dim_spk_emb)))
    jmodel = JaxF0Converter(JDEF)
    return jmodel, _init(jmodel, np.zeros((1, T, DEF.dim_freq)),
                         np.zeros((1, T, DEF.dim_f0)))


def _jax_step(monkeypatch, make_step, jmodel, params, batch):
    """JAX's own train step at the default config once: its loss and the
    gradients it hands its optimizer."""
    recorded = []

    def recording_optimizer(config):
        def update(grads, state, params=None):
            recorded.append(grads)
            return jax.tree.map(jnp.zeros_like, grads), state

        return optax.GradientTransformation(lambda p: (), update)

    monkeypatch.setattr(jax_train_step, "make_optimizer", recording_optimizer)
    state = jax_train_step.TrainState(params, (), jnp.zeros((), jnp.int32))
    _, loss = make_step(JDEF, jmodel)(state, batch, KEY)
    (grads,) = recorded
    return float(loss), grads


@pytest.mark.parametrize("name", ["speechsplit", "f0_converter"])
def test_default_config_step_matches_jax(monkeypatch, name):
    """One step of each model at the default precision: the loss within
    1e-5 relative, every gradient within 2% max-relative of JAX's."""
    jmodel, params = _jax_model(name)
    if name == "speechsplit":
        make_jax, make_port = (jax_train_step.make_train_step_fn,
                               make_train_step)
        draws = _draws(20, 4)  # the augmentation, content/pitch convs 0-2
    else:
        make_jax, make_port = (jax_train_step.make_f0_train_step_fn,
                               make_f0_train_step)
        draws = _draws(21, 3)  # f0 convs 0-2
    batch = _batch8(5)
    jq, pq = _inject(monkeypatch, draws)
    want_loss, jgrads = _jax_step(monkeypatch, make_jax, jmodel, params,
                                  batch)
    state = create_train_state(DEF, 7, name, device="cpu")
    state.model.load_state_dict(jax_params_to_state_dict(params, name),
                                strict=True)
    state, loss = make_port(DEF)(state, batch)
    assert not jq and not pq
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), name)
    got = dict(state.model.named_parameters())
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        err = float((got[key].grad - ref).abs().max())
        assert err <= GRAD_TOL * float(ref.abs().max()), (key, err)
    assert not any(bilstm.LAUNCHES.values())
    assert not any(multi_bilstm.LAUNCHES.values())


def _optax_state_mu(opt_state):
    return opt_state[0].mu


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_adam_bf16_mu_matches_optax(grad_dtype):
    """5 steps of the port's Adam at ``adam_mu_dtype="bfloat16"`` against
    ``optax.adam(mu_dtype=bfloat16)`` behind JAX's ``_cast_grads``: the
    parameters within 1e-6 absolute, mu within one bfloat16 ulp."""
    rng = np.random.RandomState(8)
    shapes = [(4, 3), (7,), (2, 5, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 10.0 ** rng.randint(-3, 2)
              for s in shapes] for _ in range(5)]
    over = dict(adam_mu_dtype="bfloat16", grad_dtype=grad_dtype)
    jcfg, cfg = JCFG.replace(**over), CFG.replace(**over)
    tx = jax_train_step.make_optimizer(jcfg)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(cfg, tparams)
    for step_grads in grads:
        jgrads = jax_train_step._cast_grads(
            jcfg, [jnp.asarray(g) for g in step_grads])
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, step_grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, j, m in zip(tparams, jparams, _optax_state_mu(opt_state)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       atol=ADAM_ATOL, rtol=0)
            mu = opt.state[p]["exp_avg"]
            assert mu.dtype == torch.bfloat16 and m.dtype == jnp.bfloat16
            assert opt.state[p]["exp_avg_sq"].dtype == torch.float32
            assert_within_one_ulp(mu, m, "mu")


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("precision,tf32", [
    ("default", True), ("high", True), ("highest", False),
    ("float32", False)])
def test_matmul_precision_spans_forward_and_backward(monkeypatch, precision,
                                                     tf32):
    """The step's forward and backward run under the TF32 setting of
    ``matmul_precision`` (JAX's GPU semantics); torch's flags are what
    they were after it."""
    seen = {}
    loss_fn = train_step.generator_loss

    def spy(config, model, batch, generator):
        seen["forward"] = _flags()
        loss = loss_fn(config, model, batch, generator)
        def hook(grad):
            seen["backward"] = _flags()

        loss.register_hook(hook)
        return loss

    monkeypatch.setattr(train_step, "generator_loss", spy)
    cfg = CFG.replace(matmul_precision=precision)
    step = make_train_step(cfg)
    state = create_train_state(cfg, 0, device="cpu")
    for before in ((False, True), (True, False)):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            before[0])
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before[1])
        seen.clear()
        _inject(monkeypatch, [(np.full((4, 5), 1.0, np.float32),
                               np.full((4, 5), CFG.min_len_seg, np.int32))]
                * 4)
        state, _ = step(state, _batch(0))
        assert seen == {"forward": (tf32, tf32), "backward": (tf32, tf32)}
        assert _flags() == before


def test_matmul_precision_refuses_what_it_does_not_map():
    with pytest.raises(ValueError, match="matmul_precision"):
        make_train_step(CFG.replace(matmul_precision="fastest"))
    with pytest.raises(ValueError, match="matmul_precision"):
        make_train_step(CFG.replace(matmul_precision="BF16_BF16_F32"))
    with pytest.raises(ValueError, match="matmul_precision"):
        with train_step.matmul_precision("medium"):
            pass


def test_jax_bf16_mu_carries_into_the_port():
    """An optax state with a bfloat16 mu (ml_dtypes leaves): the port's
    exp_avg is bfloat16 and equals JAX's mu bit for bit."""
    _, params = _jax_model("speechsplit")
    tx = jax_train_step.make_optimizer(JDEF)
    opt_state = tx.init(params)
    rng = np.random.RandomState(4)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
    _, opt_state = tx.update(grads, opt_state, params)
    numpy_state = jax.tree.map(np.asarray, opt_state)
    assert _optax_state_mu(numpy_state)["decoder"]["lstm"][
        "w_hh_l0"].dtype.name == "bfloat16"
    state = create_train_state(DEF, 0, device="cpu")
    jax_adam_state_to_torch(numpy_state, "speechsplit", state.optimizer,
                            state.model)
    want = jax_params_to_state_dict(_optax_state_mu(numpy_state),
                                    "speechsplit")
    nu = jax_params_to_state_dict(numpy_state[0].nu, "speechsplit")
    for key, p in state.model.named_parameters():
        s = state.optimizer.state[p]
        assert s["exp_avg"].dtype == torch.bfloat16
        assert torch.equal(s["exp_avg"].float(), want[key]), key
        assert s["exp_avg_sq"].dtype == torch.float32
        assert torch.equal(s["exp_avg_sq"], nu[key]), key
        assert float(s["step"]) == 1.0


@pytest.mark.parametrize("name", ["speechsplit", "f0_converter"])
def test_bf16_mu_save_and_resume_equals_the_uninterrupted_run(
        one_torch_thread, tmp_path, name):
    """At the default precision: 3 steps, save, a fresh Solver resumes, 3
    more: bit for bit the 6 uninterrupted steps, mu bfloat16 throughout."""
    cfg = CFG.replace(residual_dtype="bfloat16", adam_mu_dtype="bfloat16")
    batches = [_batch(s) for s in range(6)]
    whole = Solver(iter(batches), _run_config(
        tmp_path / "whole", num_iters=6, model=name), cfg,
        device="cpu").train()
    Solver(iter(batches[:3]), _run_config(
        tmp_path / "cut", num_iters=3, model_save_step=3, model=name), cfg,
        device="cpu").train()
    resumed = Solver(iter(batches[3:]), _run_config(
        tmp_path / "cut", num_iters=3, resume_iters=3, model_save_step=3,
        model=name), cfg, device="cpu").train()
    a, b = _snapshot(whole), _snapshot(resumed)
    assert a["step"] == b["step"] == 6
    assert torch.equal(a["generator"], b["generator"])
    for key in a["params"]:
        assert torch.equal(a["params"][key], b["params"][key]), key
    for i in a["moments"]:
        assert a["moments"][i]["exp_avg"].dtype == torch.bfloat16
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a["moments"][i][k], b["moments"][i][k]), (i, k)


def test_cli_trains_the_default_config(tmp_path):
    """``cli.train`` with no precision in --hparams (tiny widths only):
    trains, saves, and resumes into a state equal to the checkpoint's."""
    tree = write_feature_tree(str(tmp_path / "feats"), 3, 2, seed=2)
    widths = ",".join(f"{k}={getattr(DEF, k)}" for k in (
        "dim_enc", "dim_enc_2", "dim_enc_3", "dim_neck", "dim_neck_2",
        "dim_neck_3", "dim_dec_mel", "dim_dec_f0", "max_len_pad",
        "max_len_seq", "min_len_seq"))

    def args(*extra):
        return ["--device", "cpu", "--log_step", "1", "--sample_step", "1000",
                "--model_save_dir", str(tmp_path / "models"),
                "--sample_dir", str(tmp_path / "samples"),
                "--log_dir", str(tmp_path / "logs"),
                "--validation_path", str(tmp_path / "missing.pkl"),
                "--hparams", f"root_dir={tree[0]},feat_dir={tree[1]},"
                f"batch_size=4,{widths}", *extra]

    state = cli_train.main(args("--num_iters", "2", "--model_save_step", "2"))
    assert state.step == 2
    assert state.optimizer.mu_dtype == torch.bfloat16
    assert state.model.decoder.lstm.residual_dtype == torch.bfloat16
    saved = torch.load(ckpt_lib.checkpoint_path(str(tmp_path / "models"), 2),
                       map_location="cpu", weights_only=True)
    resumed = create_train_state(DEF, 0, device="cpu")
    ckpt_lib.restore_checkpoint(str(tmp_path / "models"), 2, resumed)
    for i, (key, p) in enumerate(resumed.model.named_parameters()):
        assert torch.equal(p.detach(), saved["model"][key]), key
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(resumed.optimizer.state[p][k],
                               saved["optimizer"]["state"][i][k]), (key, k)
    assert resumed.optimizer.state[p]["exp_avg"].dtype == torch.bfloat16
    state = cli_train.main(args("--resume_iters", "2", "--num_iters", "1",
                                "--model_save_step", "3"))
    assert state.step == 3
    assert sorted(os.listdir(tmp_path / "models")) == ["2-G.ckpt", "3-G.ckpt"]
