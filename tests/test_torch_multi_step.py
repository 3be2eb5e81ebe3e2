"""K train steps a call in the port: ``data.prefetch.stack_batches``
against JAX's, ``make_train_multi_step`` against k single steps, the
Solver's k-step loop and device-resident data (its cadence check, its
trajectory against the host loader's, its resume) and ``cli.train``'s
``--steps_per_dispatch``, ``--data_on_device`` and ``--wav_dir``.

The port runs a k-step call as the single step's own calls on the
slices, drawing from ``TrainState.generator`` in the same order, so on
the CPU every comparison here is bit for bit (JAX's scan allows fusion
noise because it compiles another program)."""

import os

import numpy as np
import pytest
import torch

from speechsplit_tpu.data.prefetch import stack_batches as jax_stack_batches
from speechsplit_tpu.data.synthetic import make_corpus
from speechsplit_tpu_torch.cli import train as cli_train
from speechsplit_tpu_torch.data import Batch, SpeakerDataset, data_loader
from speechsplit_tpu_torch.data import resident as resident_lib
from speechsplit_tpu_torch.data.prefetch import stack_batches
from speechsplit_tpu_torch.training import (
    Solver,
    SolverConfig,
    create_train_state,
    make_f0_train_step,
    make_train_multi_step,
    make_train_step,
)
from tests.test_torch_data import write_feature_tree
from tests.test_torch_solver import TINY_HPARAMS, _snapshot
from tests.test_torch_training import CFG
from tests.test_torch_training import _batch as _jax_collated

DEFAULT_CFG = CFG.replace(residual_dtype="bfloat16", adam_mu_dtype="bfloat16")
CONFIGS = {"float32": CFG, "default": DEFAULT_CFG}
SINGLE = {"speechsplit": make_train_step, "f0_converter": make_f0_train_step}


def _batch(seed):
    """A seeded B4 host batch (JAX's collator, as the port's)."""
    return Batch(*_jax_collated(seed))


def _assert_same_state(a, b):
    sa, sb = _snapshot(a), _snapshot(b)
    assert sa["step"] == sb["step"]
    assert torch.equal(sa["generator"], sb["generator"])
    for key in sa["params"]:
        assert torch.equal(sa["params"][key], sb["params"][key]), key
    for i in sa["moments"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["moments"][i][k], sb["moments"][i][k]), (
                i, k)


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


def test_stack_batches_shapes_and_remainder():
    batches = [_batch(s) for s in range(7)]
    stacked = list(stack_batches(iter(batches), 3))
    want = list(jax_stack_batches(iter(batches), 3))
    assert len(stacked) == len(want) == 2  # trailing group of 1 dropped
    assert type(stacked[0]) is type(batches[0])
    assert stacked[0].mel.shape == (3, 4, CFG.max_len_pad, CFG.dim_freq)
    assert stacked[0].len_org.shape == (3, 4)
    for got, ref in zip(stacked, want):
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(stacked[1].mel[0], batches[3].mel)


@pytest.mark.parametrize("k", [0, -1])
def test_stack_batches_rejects_nonpositive_k(k):
    with pytest.raises(ValueError, match="positive"):
        next(stack_batches(iter([]), k))


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("model", sorted(SINGLE))
def test_multi_step_equals_single_steps(model, config):
    """One k=4 call against 4 single steps from the same state on the
    same batches: losses, parameters, Adam moments and the draws'
    generator bit for bit."""
    cfg = CONFIGS[config]
    batches = [_batch(10 + s) for s in range(4)]
    single = SINGLE[model](cfg)
    a = create_train_state(cfg, 3, model, device="cpu")
    want = []
    for batch in batches:
        a, loss = single(a, batch)
        want.append(loss)
    b = create_train_state(cfg, 3, model, device="cpu")
    b, losses = make_train_multi_step(cfg, model)(
        b, next(stack_batches(iter(batches), 4)))
    assert losses.shape == (4,)
    assert torch.equal(losses, torch.stack(want))
    assert a.step == b.step == 4
    _assert_same_state(a, b)


def test_multi_step_rejects_an_unknown_model():
    with pytest.raises(ValueError, match="unknown model"):
        make_train_multi_step(CFG, "vocoder")


def _run_config(path, **overrides):
    base = dict(
        num_iters=4, log_step=2, sample_step=1000, model_save_step=4,
        model_save_dir=str(path / "models"), sample_dir=str(path / "samples"),
        log_dir=str(path / "logs"),
        validation_path=str(path / "missing.pkl"))
    base.update(overrides)
    return SolverConfig(**base)


@pytest.mark.parametrize("name", ["log_step", "model_save_step",
                                  "sample_step", "num_iters"])
def test_solver_refuses_a_cadence_inside_a_dispatch(tmp_path, name):
    rc = _run_config(tmp_path, steps_per_dispatch=2, **{name: 3})
    with pytest.raises(ValueError, match=f"must divide {name}=3"):
        Solver(None, rc, CFG, device="cpu")


def test_solver_data_on_device_requires_a_store(tmp_path):
    with pytest.raises(ValueError, match="dataset"):
        Solver(None, _run_config(tmp_path, data_on_device=True), CFG,
               device="cpu")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root, feat = write_feature_tree(str(tmp_path_factory.mktemp("feats")), 3,
                                    [2, 1, 3], seed=6)
    return SpeakerDataset(root, feat)


def _logged(out):
    return [line.split("loss_id: ")[1].split(",")[0]
            for line in out.splitlines() if "loss_id:" in line]


def test_resident_k2_solver_equals_the_host_loader(dataset, tmp_path,
                                                   capsys):
    """``Solver(data_on_device=True, steps_per_dispatch=2)`` for 4 steps
    against the host loader's Solver at k = 1: the final states and the
    ``.ckpt`` written at step 4 bit for bit, and the logged losses."""
    cfg = CFG.replace(batch_size=4)
    host = Solver(data_loader(dataset, cfg, seed=0),
                  _run_config(tmp_path / "host"), cfg, device="cpu")
    host_state = host.train()
    host_logged = _logged(capsys.readouterr().out)
    resident = Solver(None, _run_config(
        tmp_path / "res", data_on_device=True, steps_per_dispatch=2), cfg,
        dataset=dataset, device="cpu")
    assert resident._resident[0].mel.dtype == torch.float32
    res_state = resident.train()
    assert _logged(capsys.readouterr().out) == host_logged
    assert len(host_logged) == 2
    assert res_state.step == host_state.step == 4
    _assert_same_state(host_state, res_state)
    saved = [torch.load(path / "models" / "4-G.ckpt", map_location="cpu",
                        weights_only=True)
             for path in (tmp_path / "host", tmp_path / "res")]
    assert sorted(os.listdir(tmp_path / "res" / "models")) == ["4-G.ckpt"]
    assert saved[0]["step"] == saved[1]["step"] == 4
    assert torch.equal(saved[0]["generator"], saved[1]["generator"])
    for key, value in saved[0]["model"].items():
        assert torch.equal(value, saved[1]["model"][key]), key


def test_resumed_resident_run_equals_the_uninterrupted_one(dataset,
                                                           tmp_path):
    """A resident k=2 run cut at step 2 and resumed for 2 more restarts
    its plans from the seed, as the host loader does: it equals the
    uninterrupted steps on plans 1, 2, 1, 2, and the host loader's run
    cut and resumed the same way, bit for bit."""
    cfg = CFG.replace(batch_size=4)

    def cut_and_resume(path, loader_for, **options):
        for resume in (None, 2):
            rc = _run_config(path, num_iters=2, model_save_step=2,
                             log_step=2, resume_iters=resume, **options)
            state = Solver(loader_for(), rc, cfg, dataset=dataset,
                           device="cpu").train()
        return state

    resumed = cut_and_resume(tmp_path / "res", lambda: None,
                             data_on_device=True, steps_per_dispatch=2)
    host = cut_and_resume(tmp_path / "host",
                          lambda: data_loader(dataset, cfg, seed=0))
    features, utts = resident_lib.build_resident(dataset, cfg, device="cpu")
    step = resident_lib.make_resident_train_step(cfg, features)
    plans = resident_lib.plan_batches(utts, features.length.numpy(), cfg,
                                      seed=0)
    first = [next(plans), next(plans)]
    whole = create_train_state(cfg, 0, device="cpu")
    for plan in first + first:
        whole, _ = step(whole, plan)
    assert resumed.step == host.step == whole.step == 4
    _assert_same_state(whole, resumed)
    _assert_same_state(host, resumed)


def _cli_args(tmp_path, *extra):
    return [
        "--num_iters", "4", "--log_step", "2", "--model_save_step", "4",
        "--sample_step", "1000",
        "--model_save_dir", str(tmp_path / "models"),
        "--sample_dir", str(tmp_path / "samples"),
        "--log_dir", str(tmp_path / "logs"),
        "--validation_path", str(tmp_path / "missing.pkl"),
        "--hparams", "batch_size=2," + TINY_HPARAMS, *extra]


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "wavs")
    make_corpus(path, 5, n_speakers=2, duration_s=0.6)
    return path


def test_cli_wav_dir_requires_data_on_device(tmp_path, wav_dir):
    with pytest.raises(SystemExit, match="--wav_dir requires "
                       "--data_on_device"):
        cli_train.main(_cli_args(tmp_path, "--wav_dir", wav_dir,
                                 "--device", "cpu"))


def test_cli_trains_from_a_wav_tree(tmp_path, wav_dir, capsys):
    """``--wav_dir --data_on_device --steps_per_dispatch 2`` at small
    hparams: a bfloat16 store from the wavs (genders from a missing
    ``--spk2gen``: all "M"), 2 calls of 2 steps, a loss logged at each,
    the checkpoint at step 4."""
    state = cli_train.main(_cli_args(
        tmp_path, "--wav_dir", wav_dir, "--data_on_device",
        "--steps_per_dispatch", "2", "--resident_dtype", "bfloat16",
        "--spk2gen", str(tmp_path / "no_such.pkl"), "--device", "cpu"))
    assert state.step == 4
    assert os.listdir(tmp_path / "models") == ["4-G.ckpt"]
    logged = [float(v) for v in _logged(capsys.readouterr().out)]
    assert len(logged) == 2 and np.isfinite(logged).all()
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_cli_still_refuses_several_devices(tmp_path):
    """Named from when ``--num_devices 2`` was refused: it now trains on
    two gloo ranks with ``--steps_per_dispatch 2 --data_on_device`` (each
    rank holds the store, gathers its row of each global plan), 2 calls
    of 2 steps, rank 0's checkpoint at step 4."""
    tree = write_feature_tree(str(tmp_path / "feats"), 3, 2, seed=4)
    args = _cli_args(tmp_path, "--num_devices", "2", "--device", "cpu",
                     "--steps_per_dispatch", "2", "--data_on_device")
    args[args.index("--hparams") + 1] += (f",root_dir={tree[0]},"
                                          f"feat_dir={tree[1]}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli_train.main(args) is None
    finally:
        torch.set_num_threads(threads)
    assert os.listdir(tmp_path / "models") == ["4-G.ckpt"]
    raw = torch.load(tmp_path / "models" / "4-G.ckpt", map_location="cpu",
                     weights_only=True)
    assert raw["step"] == 4
