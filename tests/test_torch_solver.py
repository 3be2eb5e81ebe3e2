"""The port's trainer against the JAX package's at a tiny config: the
Solver's steps against JAX's raw train steps plus optax Adam, checkpoints
in the reference's format, save-and-resume against the uninterrupted
run, pruning, validation and its renders, the Adam state carried over
from JAX, ``cli.train`` (on two gloo ranks too) and what it refuses.

As in ``test_torch_training.py``, the resampling draws are injected into
both packages where the two are compared; save-and-resume runs the
port's own ``torch.Generator`` draws, since its state is what a
checkpoint must carry."""

import functools
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.models import encoders as jax_encoders
from speechsplit_tpu.ops import interp as jax_interp
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu.training.solver import Solver as JaxSolver
from speechsplit_tpu_torch.cli import train as cli_train
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import (
    jax_adam_state_to_torch,
    jax_params_to_state_dict,
    load_reference_checkpoint,
)
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.training import Solver, SolverConfig
from speechsplit_tpu_torch.training import checkpoint as ckpt_lib
from speechsplit_tpu_torch.training import create_train_state, make_train_step
from tests.test_torch_data import write_feature_tree
from tests.test_torch_training import (  # noqa: F401 (gather_form: autouse)
    CFG,
    JCFG,
    KEY,
    T,
    _batch,
    _draws,
    _init,
    _inject,
    gather_form,
)

# draws a step: the augmentation's and content/pitch convs 0-2, or the
# F0 converter's convs 0-2
DRAWS = {"speechsplit": 4, "f0_converter": 3}
TAGS = {"speechsplit": "G", "f0_converter": "P"}
# the tiny config as --hparams, float32 residuals and Adam moments
TINY_HPARAMS = ",".join(
    f"{k}={getattr(CFG, k)}" for k in (
        "dim_enc", "dim_enc_2", "dim_enc_3", "dim_neck", "dim_neck_2",
        "dim_neck_3", "dim_dec_mel", "dim_dec_f0", "max_len_pad",
        "max_len_seq", "min_len_seq", "residual_dtype", "adam_mu_dtype"))


def _run_config(tmp_path, **overrides) -> SolverConfig:
    base = dict(
        num_iters=3, log_step=1, sample_step=1000, model_save_step=1000,
        model_save_dir=str(tmp_path / "models"),
        sample_dir=str(tmp_path / "samples"), log_dir=str(tmp_path / "logs"),
        validation_path=str(tmp_path / "missing.pkl"))
    base.update(overrides)
    return SolverConfig(**base)


@functools.cache
def _jax_init(name):
    """JAX's model and initial params, once a model for the module (the
    params are immutable arrays; every test starts from them)."""
    if name == "speechsplit":
        jmodel = JaxSpeechSplit(JCFG)
        params = _init(jmodel, np.zeros((1, T, CFG.dim_freq + CFG.dim_f0)),
                       np.zeros((1, T, CFG.dim_freq)),
                       np.zeros((1, CFG.dim_spk_emb)))
    else:
        jmodel = JaxF0Converter(JCFG)
        params = _init(jmodel, np.zeros((1, T, CFG.dim_freq)),
                       np.zeros((1, T, CFG.dim_f0)))
    return jmodel, params


@functools.cache
def _jax_step_fn(name):
    """JAX's raw train step (``make_train_step_fn``, optax Adam), jitted
    once a model for the module, as JAX's ``make_train_step`` jits it. A
    step's resampling draws are its argument: the injected
    ``random_resample`` pops them as the step traces, the draws an
    unjitted step pops from ``_inject``'s queue, in the same order."""
    jmodel, _ = _jax_init(name)
    make = (jax_train_step.make_train_step_fn if name == "speechsplit"
            else jax_train_step.make_f0_train_step_fn)
    step = make(JCFG, jmodel)

    def run(state, batch, key, draws):
        queue = list(draws)

        def fake(x, len_seq, key, *, max_len_seg, max_len_pad, **_):
            scales, len_seg = queue.pop(0)
            return jax_interp.resample_fixed(
                x, len_seq, scales, len_seg, max_len_pad=max_len_pad,
                seg_span=2 * max_len_seg)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_train_step, "random_resample", fake)
            mp.setattr(jax_encoders, "random_resample", fake)
            out = step(state, batch, key)
        assert not queue
        return out

    return jax.jit(run)


def _jax_steps(name, state, batches, draws):
    """JAX's steps on ``batches``, each on its ``DRAWS[name]`` draws."""
    step, per = _jax_step_fn(name), DRAWS[name]
    assert len(draws) == per * len(batches)
    losses = []
    for i, batch in enumerate(batches):
        state, loss = step(state, batch, KEY, draws[per * i: per * (i + 1)])
        losses.append(float(loss))
    return state, losses


def _recording(solver):
    """Record the loss of each step the solver runs."""
    losses, step = [], solver.train_step

    def run(state, batch):
        state, loss = step(state, batch)
        losses.append(float(loss))
        return state, loss

    solver.train_step = run
    return losses


def _assert_params_close(model, jparams, name, atol):
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jparams), name)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), ref.numpy(),
                                   atol=atol, rtol=0, err_msg=key)


@pytest.fixture(scope="module", autouse=True)
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


@pytest.mark.parametrize("name", ["speechsplit", "f0_converter"])
def test_solver_steps_match_jax_steps(monkeypatch, tmp_path, name):
    """3 Solver steps against 3 of JAX's raw steps with optax Adam, from
    the same params on the same batches: losses at rtol 1e-5, params
    after the 3 Adam updates (lr 1e-4 each) within 1e-6."""
    batches = [_batch(s) for s in range(3)]
    _, params = _jax_init(name)
    draws = _draws(20, 3 * DRAWS[name])
    _, pq = _inject(monkeypatch, draws)
    tx = jax_train_step.make_optimizer(JCFG)
    jstate = jax_train_step.TrainState(params, tx.init(params),
                                       jnp.zeros((), jnp.int32))
    jstate, want = _jax_steps(name, jstate, batches, draws)

    solver = Solver(iter(batches), _run_config(tmp_path, model=name), CFG,
                    device="cpu")
    solver.state.model.load_state_dict(jax_params_to_state_dict(params, name))
    got = _recording(solver)
    state = solver.train()
    assert not pq
    assert state.step == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(state.model, jstate.params, name, atol=1e-6)


@pytest.mark.parametrize("name", ["speechsplit", "f0_converter"])
def test_checkpoint_naming_and_contents(tmp_path, name):
    solver = Solver(iter([_batch(0), _batch(1)]),
                    _run_config(tmp_path, num_iters=2, model_save_step=2,
                                model=name), CFG, device="cpu")
    state = solver.train()
    path = tmp_path / "models" / f"2-{TAGS[name]}.ckpt"
    assert sorted(os.listdir(tmp_path / "models")) == [path.name]
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert sorted(raw) == ["generator", "model", "optimizer", "step"]
    assert raw["step"] == 2
    assert torch.equal(raw["generator"], state.generator.get_state())
    model = (SpeechSplit if name == "speechsplit" else F0Converter)(CFG)
    model.load_state_dict(load_reference_checkpoint(str(path)), strict=True)
    for key, value in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    opt = raw["optimizer"]["state"]
    assert len(opt) == len(list(state.model.parameters()))
    assert all(float(s["step"]) == 2.0 for s in opt.values())


def _snapshot(state):
    opt = state.optimizer.state_dict()
    return dict(
        params={k: v.detach().clone() for k, v in
                state.model.state_dict().items()},
        moments={i: {k: v.clone() for k, v in s.items()}
                 for i, s in opt["state"].items()},
        step=state.step,
        generator=state.generator.get_state(),
    )


@pytest.mark.parametrize("name", ["speechsplit", "f0_converter"])
def test_save_and_resume_equals_the_uninterrupted_run(tmp_path, name):
    """3 steps, save, a fresh Solver resumes, 3 more: bit for bit the 6
    uninterrupted steps (params, Adam moments, step, the draws'
    generator), on the same batches."""
    batches = [_batch(s) for s in range(6)]
    whole = Solver(iter(batches), _run_config(
        tmp_path / "whole", num_iters=6, model=name), CFG,
        device="cpu").train()

    rc = _run_config(tmp_path / "cut", num_iters=3, model_save_step=3,
                     model=name)
    Solver(iter(batches[:3]), rc, CFG, device="cpu").train()
    resumed = Solver(iter(batches[3:]), _run_config(
        tmp_path / "cut", num_iters=3, resume_iters=3, model_save_step=3,
        model=name), CFG, device="cpu").train()

    a, b = _snapshot(whole), _snapshot(resumed)
    assert a["step"] == b["step"] == 6
    assert torch.equal(a["generator"], b["generator"])
    for key in a["params"]:
        assert torch.equal(a["params"][key], b["params"][key]), key
    assert sorted(a["moments"]) == sorted(b["moments"])
    for i in a["moments"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a["moments"][i][k], b["moments"][i][k]), (i, k)
    assert ckpt_lib.checkpoint_steps(str(tmp_path / "cut" / "models"),
                                     TAGS[name]) == [3, 6]


def test_pruning_keeps_the_newest(tmp_path):
    state = Solver(None, _run_config(tmp_path), CFG, device="cpu").state
    for step in (1, 2, 3, 4):
        ckpt_lib.save_checkpoint(str(tmp_path), step, state)
    ckpt_lib.save_checkpoint(str(tmp_path), 9, state, tag="P")
    ckpt_lib.prune_checkpoints(str(tmp_path), keep=2)
    assert ckpt_lib.checkpoint_steps(str(tmp_path)) == [3, 4]
    ckpt_lib.prune_checkpoints(str(tmp_path), keep=0)  # 0 = keep all
    assert ckpt_lib.checkpoint_steps(str(tmp_path)) == [3, 4]
    assert ckpt_lib.checkpoint_steps(str(tmp_path), "P") == [9]
    assert ckpt_lib.latest_checkpoint_step(str(tmp_path)) == 4
    assert ckpt_lib.latest_checkpoint_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError, match="2-G.ckpt"):
        ckpt_lib.restore_checkpoint(str(tmp_path), 2, state)


def _rounding_edge_f0(count):
    """Contour values whose bin differs between float64 and float32
    quantization (the JAX package quantizes in float32)."""
    rng = np.random.default_rng(2)
    out = []
    while len(out) < count:
        k = int(rng.integers(1, 250))
        x = (k + 0.5) / 255.0 + rng.uniform(-1e-9, 1e-9)
        wide = np.round(np.float64(x) * 255.0)
        narrow = np.round(np.float32(x) * np.float32(255.0))
        if wide != narrow:
            out.append(x)
    return np.array(out, np.float64)


def _demo(path):
    """A two-utterance demo pickle (entries [speaker, emb, (mel, f0, len,
    uid)]), one embedding flat and one (1, 82) as the reference's."""
    rng = np.random.default_rng(5)
    entries = []
    for i, length in enumerate((24, 29)):
        mel = rng.random((length, CFG.dim_freq)).astype(np.float32)
        f0 = np.where(rng.random(length) < 0.3, 0.0, rng.random(length))
        f0[:4] = _rounding_edge_f0(4)
        emb = np.eye(CFG.dim_spk_emb, dtype=np.float32)[i + 2]
        entries.append([f"p{i:03d}", emb if i else emb[None], (
            mel, f0, length, f"p{i:03d}_001")])
    with open(path, "wb") as handle:
        pickle.dump(entries, handle)
    return entries


def test_validate_matches_jax(tmp_path):
    entries = _demo(tmp_path / "demo.pkl")
    jmodel, params = _jax_init("speechsplit")
    solver = Solver(None, _run_config(
        tmp_path, validation_path=str(tmp_path / "demo.pkl")), CFG,
        device="cpu")
    solver.state.model.load_state_dict(
        jax_params_to_state_dict(params, "speechsplit"))
    jax_like = types.SimpleNamespace(config=JCFG)
    want = []
    for entry in entries:
        x_f0, x_pad, emb = JaxSolver._prepare_val_inputs(jax_like, entry)
        ours = solver._prepare_val_inputs(entry)
        for a, b in zip(ours, (x_f0, x_pad, emb)):
            np.testing.assert_array_equal(a.numpy(), b)
        out = jmodel.apply({"params": params}, x_f0, x_pad, emb, train=False)
        want.append(float(jnp.sum(jnp.square(jnp.asarray(x_pad) - out))))
    np.testing.assert_allclose(solver.validate(), float(np.mean(want)),
                               rtol=5e-5)


def test_render_samples_writes_the_panels(tmp_path):
    _demo(tmp_path / "demo.pkl")
    solver = Solver(None, _run_config(
        tmp_path, validation_path=str(tmp_path / "demo.pkl")), CFG,
        device="cpu")
    os.makedirs(solver.rc.sample_dir)
    solver.render_samples(7)
    assert sorted(os.listdir(solver.rc.sample_dir)) == [
        "7_p000_2.png", "7_p001_2.png"]


def test_solver_cadences_and_profile(tmp_path, capsys):
    """Validation and renders at sample_step, logs at log_step, a chrome
    trace of profile_steps steps from profile_start."""
    _demo(tmp_path / "demo.pkl")
    rc = _run_config(tmp_path, num_iters=4, log_step=2, sample_step=4,
                     validation_path=str(tmp_path / "demo.pkl"),
                     profile_dir=str(tmp_path / "trace"), profile_start=1,
                     profile_steps=2)
    Solver(iter([_batch(s) for s in range(4)]), rc, CFG,
           device="cpu").train()
    out = capsys.readouterr().out
    assert out.count("G/loss_id:") == 2
    assert out.count("Validation loss:") == 1
    assert sorted(os.listdir(tmp_path / "trace")) == ["trace_3.json"]
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "4_p000_2.png", "4_p001_2.png"]


def test_non_finite_loss_stops_the_solver(tmp_path):
    bad = _batch(0)
    bad = bad._replace(mel=np.full_like(bad.mel, np.nan))
    solver = Solver(iter([bad]), _run_config(tmp_path, num_iters=1), CFG,
                    device="cpu")
    with pytest.raises(FloatingPointError, match="step 1"):
        solver.train()


def test_jax_adam_state_carries_into_torch(monkeypatch):
    """2 JAX steps; carry params and Adam state into the port; one more
    step in each: the params agree within 1e-6."""
    batches = [_batch(s) for s in range(3)]
    draws = _draws(30, 3 * DRAWS["speechsplit"])
    _, params = _jax_init("speechsplit")
    tx = jax_train_step.make_optimizer(JCFG)
    jstate = jax_train_step.TrainState(params, tx.init(params),
                                       jnp.zeros((), jnp.int32))
    jstate, _ = _jax_steps("speechsplit", jstate, batches[:2], draws[:8])

    state = create_train_state(CFG, 0, device="cpu")
    state.model.load_state_dict(jax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params), "speechsplit"), strict=True)
    jax_adam_state_to_torch(jax.tree.map(np.asarray, jstate.opt_state),
                            "speechsplit", state.optimizer, state.model)
    _, pq = _inject(monkeypatch, draws[8:])
    jstate, _ = _jax_steps("speechsplit", jstate, batches[2:], draws[8:])
    state, _ = make_train_step(CFG)(state, batches[2])
    assert not pq
    _assert_params_close(state.model, jstate.params, "speechsplit",
                         atol=1e-6)
    for p in state.model.parameters():
        assert float(state.optimizer.state[p]["step"]) == 3.0


def _cli_args(tmp_path, tree, *extra):
    root_dir, feat_dir = tree
    return [
        "--num_iters", "2", "--log_step", "1", "--model_save_step", "2",
        "--sample_step", "1000",
        "--model_save_dir", str(tmp_path / "models"),
        "--sample_dir", str(tmp_path / "samples"),
        "--log_dir", str(tmp_path / "logs"),
        "--validation_path", str(tmp_path / "missing.pkl"),
        "--hparams", f"root_dir={root_dir},feat_dir={feat_dir},batch_size=4,"
        + TINY_HPARAMS, *extra]


@pytest.mark.parametrize("extra,files", [
    (("--device", "cpu", "--num_devices", "1"), ["2-G.ckpt"]),
    (("--device", "cpu", "--model", "f0_converter", "--lazy_data",
      "--compress_transfers", "--keep_checkpoints", "1",
      "--model_save_step", "1"), ["2-P.ckpt"]),
], ids=["generator", "f0_converter_lazy_compressed_pruned"])
def test_cli_train_on_cpu(tmp_path, extra, files):
    tree = write_feature_tree(str(tmp_path / "feats"), 3, 2, seed=1)
    state = cli_train.main(_cli_args(tmp_path, tree, *extra))
    assert state.step == 2
    assert sorted(os.listdir(tmp_path / "models")) == files
    # resume: runs 1 more (num_iters += resume_iters) and saves 3
    if files == ["2-G.ckpt"]:
        state = cli_train.main(_cli_args(
            tmp_path, tree, "--device", "cpu", "--resume_iters", "2",
            "--num_iters", "1", "--model_save_step", "3"))
        assert state.step == 3
        assert sorted(os.listdir(tmp_path / "models")) == [
            "2-G.ckpt", "3-G.ckpt"]


# --steps_per_dispatch, --data_on_device, --resident_dtype, --wav_dir and
# --spk2gen train since the port has device-resident data
# (tests/test_torch_multi_step.py); --num_devices above 1 since it has
# data-parallel training (tests/test_torch_parallel.py). The name is
# kept from when these flags were refused.
@pytest.mark.parametrize("flags", [
    ("--num_devices", "2"),
], ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_unported_flags(tmp_path, flags):
    """``--device cpu --num_devices 2`` spawns two gloo ranks, each on
    2 rows of the global batch of 4; rank 0 writes the one checkpoint
    (the spawned ranks run one torch thread each)."""
    tree = write_feature_tree(str(tmp_path / "feats"), 3, 2, seed=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = cli_train.main(_cli_args(tmp_path, tree, "--device", "cpu",
                                         *flags))
    finally:
        torch.set_num_threads(threads)
    assert state is None  # the ranks ran in their own processes
    assert os.listdir(tmp_path / "models") == ["2-G.ckpt"]
    raw = torch.load(tmp_path / "models" / "2-G.ckpt", map_location="cpu",
                     weights_only=True)
    assert raw["step"] == 2


def test_cli_refuses_the_default_bfloat16_config(tmp_path, monkeypatch):
    # the default config trains (tests/test_torch_precision.py), and
    # compute_dtype=bfloat16 too (tests/test_torch_compute_bf16_f0.py);
    # so does bfloat16 compute with the projection fused into the merged
    # kernels (PROJ_FUSION="auto"), which once refused: the fused op runs
    # under autograd at bfloat16 x, W_ih and W_hh, and the step is finite
    from speechsplit_tpu_torch.ops import bilstm

    tree = write_feature_tree(str(tmp_path / "feats"), 2, 1, seed=0)
    args = _cli_args(tmp_path, tree, "--device", "cpu")
    args[args.index("--hparams") + 1] += ",compute_dtype=bfloat16"
    monkeypatch.setattr(bilstm, "PROJ_FUSION", "auto")
    fused = []
    real = bilstm.bilstm_sequence_fused

    def spy(x, *rest, **kwargs):
        fused.append((x.dtype, torch.is_grad_enabled()))
        return real(x, *rest, **kwargs)

    monkeypatch.setattr(bilstm, "bilstm_sequence_fused", spy)
    state = cli_train.main(args)
    assert state.step == 2
    assert state.model.decoder.lstm.dtype == torch.bfloat16
    # the mel decoder's 3 layers and content layer 1, each step
    assert fused == [(torch.bfloat16, True)] * 8
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert os.path.exists(tmp_path / "models" / "2-G.ckpt")



def test_solver_refuses_a_mesh_and_defaults_to_cuda(tmp_path, monkeypatch):
    # a mesh_shape must be (world,): with no mesh the world is one rank
    with pytest.raises(ValueError, match=r"mesh_shape=\(2,\)"):
        Solver(None, _run_config(tmp_path), CFG.replace(mesh_shape=(2,)),
               device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver(None, _run_config(tmp_path), CFG)
    tree = write_feature_tree(str(tmp_path / "feats"), 2, 1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train.main(_cli_args(tmp_path, tree))
