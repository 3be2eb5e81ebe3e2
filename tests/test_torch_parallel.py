"""Data-parallel training of the port on the CPU: two gloo ranks, each
on its half of a global batch of 4 at the tiny config of
``test_torch_training.py``, against one process at the global batch.

Compared over 3-4 steps: the generator in one-hot mode (the DDP step and
the explicit all-reduce step), the F0 converter (the global masked
mean), learned mode with the contrastive term over the global batch
(speakers that pair across the ranks), a k-step call and resident steps
(``[B]`` and ``[k, B]`` plans). Bars: JAX's own for its mesh
(tests/test_shard_map_step.py:59-70), the loss within 1e-5 and every
parameter within 1e-4; at bfloat16 gradients PARITY.md #10's 2% on the
loss. Every rank starts from rank 0's parameters only through the
step's broadcast: the other rank's are moved away first. At bfloat16
gradients one step's reduced gradient is also held bit for bit to the
ranks' local gradients cast before the sum.

The one-process trajectories are held to JAX's steps on the same draws
(the draws the port made, injected into JAX as
``test_torch_solver.py`` does), at that file's bars; learned mode's
two-rank run to JAX's ``make_train_step_shard_map`` on a two-device
CPU mesh, each device drawing its rows of the same global draws.

The ranks are spawned by ``parallel.launch``: a file store under the
test's temporary directory (no port to collide on), one torch thread a
rank, a time limit on the join; a rank's failure fails the test.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from speechsplit_tpu import interop as jax_interop
from speechsplit_tpu.data.collator import Batch as JaxBatch
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.models import encoders as jax_encoders
from speechsplit_tpu.ops import interp as jax_interp
from speechsplit_tpu.parallel import batch_sharding
from speechsplit_tpu.parallel import make_mesh as jax_make_mesh
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu_torch import parallel
from speechsplit_tpu_torch.cli import train as cli_train
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import jax_params_to_state_dict
from speechsplit_tpu_torch.models import SpeechSplit
from speechsplit_tpu_torch.ops import interp
from speechsplit_tpu_torch.training import create_train_state
from tests import torch_parallel_workers as workers
from tests.test_torch_data import write_feature_tree
from tests.test_torch_learned_step import JCFG as LEARNED_JCFG
from tests.test_torch_learned_step import learned_batch
from tests.test_torch_solver import (
    DRAWS,
    _cli_args,
    _jax_steps,
)
from tests.test_torch_training import (  # noqa: F401 (gather_form: autouse)
    CFG,
    JCFG,
    KEY,
    T,
    _batch,
    gather_form,
)

LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4
# one process against JAX's steps after 3 Adam updates (lr 1e-4): the
# elements whose gradient is near zero move by lr * sign, so float noise
# there shows (the F0 converter's run put one of 2304 elements 1.8e-6
# apart); an order under JAX's mesh bar
JAX_PARAM_ATOL = 1e-5
BF16_LOSS_RTOL = 0.02
CONTRAST = 0.5
# rows 0 and 2 (ranks 0 and 1) share a speaker: a positive across ranks
SPEAKERS = (5, 11, 5, 40)
LEARNED_JCFG = LEARNED_JCFG.replace(spk_contrast_weight=CONTRAST)
LEARNED_CFG = SpeechSplitConfig(**dataclasses.asdict(LEARNED_JCFG))
BF16_GRADS = CFG.replace(grad_dtype="bfloat16")
TIMEOUT_S = 240.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread here and in the ranks: the port's ops at
    these widths are many small ones (ROADMAP.md T0)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _start(config, name):
    """A seeded port model's state dict (the ranks' start)."""
    state = create_train_state(config, 7, name, device="cpu")
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


def _jax_params(start, name):
    """``start`` as JAX's parameter tree: JAX's interop for the
    reference's modules, and the learned speaker encoder's arrays (the
    inverse of the port's ``interop._speaker_encoder_arrays``)."""
    ref = {k: v for k, v in start.items()
           if not k.startswith("speaker_encoder.")}
    params = jax_interop.torch_state_dict_to_params(ref, name)
    if len(ref) < len(start):
        node = params["speaker_encoder"] = {}
        for i in range(3):
            node[f"conv_{i}"] = dict(
                kernel=start[f"speaker_encoder.conv_{i}.conv.weight"]
                .numpy().transpose(2, 1, 0),
                bias=start[f"speaker_encoder.conv_{i}.conv.bias"].numpy())
            for field in ("scale", "bias"):
                node[f"{field}_{i}"] = start[
                    f"speaker_encoder.{field}_{i}"].numpy()
        node["proj"] = dict(
            kernel=start["speaker_encoder.proj.linear_layer.weight"]
            .numpy().T,
            bias=start["speaker_encoder.proj.linear_layer.bias"].numpy())
    return jax.tree.map(jnp.asarray, params)


def _cases(tree):
    gen, f0 = (_start(CFG, n) for n in ("speechsplit", "f0_converter"))
    learned = _start(LEARNED_CFG, "speechsplit")
    batches = [workers.numpy_batch(_batch(s)) for s in range(4)]
    learned_batches = [workers.numpy_batch(learned_batch(10 + s, SPEAKERS))
                       for s in range(3)]
    steps = dict(config=CFG, start=gen, batches=batches[:3])
    return {
        "generator": ("steps", dict(steps, model="speechsplit")),
        "generator_explicit": ("steps", dict(steps, model="speechsplit",
                                             mode="explicit")),
        "f0_converter": ("steps", dict(steps, model="f0_converter",
                                       start=f0)),
        "learned_contrast": ("steps", dict(config=LEARNED_CFG,
                                           model="speechsplit",
                                           start=learned,
                                           batches=learned_batches)),
        "k_step": ("steps", dict(steps, model="speechsplit",
                                 batches=batches, k=2)),
        "resident": ("resident_steps", dict(config=CFG, model="speechsplit",
                                            start=gen, tree=tree, calls=3)),
        "resident_k_step_f0": ("resident_steps", dict(
            config=CFG, model="f0_converter", start=f0, tree=tree, calls=2,
            k=2)),
        "bf16_grads": ("steps", dict(steps, config=BF16_GRADS,
                                     model="speechsplit")),
        "bf16_grads_explicit": ("steps", dict(steps, config=BF16_GRADS,
                                              model="speechsplit",
                                              mode="explicit")),
        "bf16_reduce": ("reduced_grads", dict(config=BF16_GRADS, start=gen,
                                              batch=batches[0])),
        "bf16_reduce_explicit": ("reduced_grads", dict(
            config=BF16_GRADS, start=gen, batch=batches[0],
            mode="explicit")),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case on two ranks and in one process; the draws the one
    process made, case by case, in order."""
    tmp = tmp_path_factory.mktemp("parallel")
    tree = write_feature_tree(str(tmp / "feats"), 4, 2, seed=3)
    cases = _cases(tree)
    parallel.launch(workers.run_cases, 2, (str(tmp), cases), device="cpu",
                    init_method=f"file://{tmp / 'store'}",
                    timeout=TIMEOUT_S, threads=1)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    draws, one = {}, {}
    real = interp.draw_segments
    for name, case in cases.items():
        made = draws[name] = []

        def recording(*args, **kwargs):
            scales, len_seg = real(*args, **kwargs)
            made.append((scales.numpy(), len_seg.numpy().astype(np.int32)))
            return scales, len_seg

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(interp, "draw_segments", recording)
            one[name] = workers.one_process({name: case})[name]
    return dict(cases=cases, ranks=ranks, one=one, draws=draws)


def _assert_follows(got, want, loss_atol=LOSS_ATOL, param_atol=PARAM_ATOL):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=loss_atol)
    assert sorted(got["params"]) == sorted(want["params"])
    for key, ref in want["params"].items():
        np.testing.assert_allclose(got["params"][key].numpy(), ref.numpy(),
                                   rtol=0, atol=param_atol, err_msg=key)


F32_CASES = ("generator", "generator_explicit", "f0_converter",
             "learned_contrast", "k_step", "resident", "resident_k_step_f0")


@pytest.mark.parametrize("name", F32_CASES)
def test_two_ranks_follow_one_process(runs, name):
    """Both ranks hold the same parameters after the steps (each starts
    from rank 0's by the step's broadcast), return the global loss, and
    follow the one-process trajectory at the global batch."""
    rank0, rank1 = (r[name] for r in runs["ranks"])
    one = runs["one"][name]
    assert rank0["step"] == rank1["step"] == one["step"] >= 3
    assert rank0["losses"] == rank1["losses"]
    for key, value in rank0["params"].items():
        assert torch.equal(value, rank1["params"][key]), key
    _assert_follows(rank0, one)


@pytest.mark.parametrize("name", ["bf16_grads", "bf16_grads_explicit"])
def test_bfloat16_gradients_reduce_narrow(runs, name):
    """``grad_dtype=bfloat16``: each rank's gradients are cast before the
    all-reduce (JAX's shard_map order), so the sum rounds where one
    process's does not. The ranks stay equal, the loss within PARITY.md
    #10's 2%; the DDP hook and the explicit step reduce alike."""
    rank0, rank1 = (r[name] for r in runs["ranks"])
    for key, value in rank0["params"].items():
        assert torch.equal(value, rank1["params"][key]), key
    np.testing.assert_allclose(rank0["losses"], runs["one"][name]["losses"],
                               rtol=BF16_LOSS_RTOL)
    other = runs["ranks"][0]["bf16_grads"]
    for key, value in rank0["params"].items():
        assert torch.equal(value, other["params"][key]), key


@pytest.mark.parametrize("name", ["bf16_reduce", "bf16_reduce_explicit"])
def test_bfloat16_cast_precedes_the_reduction(runs, name):
    """At ``grad_dtype=bfloat16`` the reduced gradient is the mean of the
    ranks' local gradients each cast to bfloat16 first, summed and halved
    in bfloat16 (JAX's shard_map order, config.py:113-114), bit for bit,
    on both ranks, through DDP's comm hook and the explicit all-reduce;
    and it is not the float32 mean cast after."""
    rank0, rank1 = (r[name] for r in runs["ranks"])
    assert sorted(rank0["reduced"]) == sorted(rank0["local"])
    differs = 0
    for key, got in rank0["reduced"].items():
        a, b = rank0["local"][key], rank1["local"][key]
        want = ((a.bfloat16() + b.bfloat16()) / 2).float()
        assert torch.equal(got, want), key
        assert torch.equal(rank1["reduced"][key], got), key
        differs += int((got != ((a + b) / 2).bfloat16().float()).sum())
    assert differs > 0


@pytest.mark.parametrize("name", ["generator", "f0_converter"])
def test_one_process_follows_jax(runs, name):
    """The one-process trajectory the ranks are held to, against JAX's
    raw steps with optax Adam on the draws the port made: the losses at
    rtol 1e-5, the parameters within 1e-6 (test_torch_solver.py's bars).
    Its one-process draws are the global batch's, so the ranks drew
    them too."""
    model = "speechsplit" if name == "generator" else name
    case = runs["cases"][name][1]
    draws = runs["draws"][name]
    assert len(draws) == DRAWS[model] * len(case["batches"])
    params = _jax_params(case["start"], model)
    tx = jax_train_step.make_optimizer(JCFG)
    jstate = jax_train_step.TrainState(params, tx.init(params),
                                       jnp.zeros((), jnp.int32))
    jstate, want = _jax_steps(model, jstate, case["batches"], draws)
    one = runs["one"][name]
    np.testing.assert_allclose(one["losses"], want, rtol=1e-5)
    want_params = jax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params), model)
    for key, ref in want_params.items():
        np.testing.assert_allclose(one["params"][key].numpy(), ref.numpy(),
                                   atol=JAX_PARAM_ATOL, rtol=0, err_msg=key)


def _jax_shard_map_steps(params, batches, draws):
    """JAX's ``make_train_step_shard_map`` on a two-device CPU mesh, one
    program for every step: each device's resampling takes its
    ``example_ids`` rows of the step's global draws (an argument)."""
    mesh = jax_make_mesh((2,), devices=jax.devices()[:2])
    module = JaxSpeechSplit(LEARNED_JCFG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda fn, **_: fn)
        raw = jax_train_step.make_train_step_shard_map(LEARNED_JCFG, module,
                                                       mesh)

    def run(state, batch, key, step_draws):
        queue = list(step_draws)

        def fake(x, len_seq, key, *, max_len_seg, max_len_pad,
                 example_ids=None, **_):
            scales, len_seg = queue.pop(0)
            return jax_interp.resample_fixed(
                x, len_seq, jnp.take(scales, example_ids, axis=0),
                jnp.take(len_seg, example_ids, axis=0),
                max_len_pad=max_len_pad, seg_span=2 * max_len_seg)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_train_step, "random_resample", fake)
            mp.setattr(jax_encoders, "random_resample", fake)
            out = raw(state, batch, key)
        assert not queue
        return out

    step = jax.jit(run)
    tx = jax_train_step.make_optimizer(LEARNED_JCFG)
    state = jax.device_put(
        jax_train_step.TrainState(params, tx.init(params),
                                  jnp.zeros((), jnp.int32)),
        NamedSharding(mesh, PartitionSpec()))
    per = DRAWS["speechsplit"]
    losses = []
    for i, batch in enumerate(batches):
        batch = jax.device_put(JaxBatch(*batch), batch_sharding(mesh))
        state, loss = step(state, batch, KEY, draws[per * i: per * (i + 1)])
        losses.append(float(loss))
    return state, losses


def test_two_ranks_with_contrast_match_jax_shard_map(runs):
    """Learned mode, contrastive weight 0.5, speakers paired across the
    ranks: the port's two gloo ranks against JAX's explicit-collective
    step on two CPU devices (the embeddings all-gathered there too), the
    same global draws, 3 steps; JAX's mesh bars."""
    case = runs["cases"]["learned_contrast"][1]
    params = _jax_params(case["start"], "speechsplit")
    assert sorted(jax_params_to_state_dict(
        jax.tree.map(np.asarray, params))) == sorted(case["start"])
    jstate, want = _jax_shard_map_steps(params, case["batches"],
                                        runs["draws"]["learned_contrast"])
    rank0 = runs["ranks"][0]["learned_contrast"]
    np.testing.assert_allclose(rank0["losses"], want, rtol=0,
                               atol=LOSS_ATOL)
    want_params = jax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params), "speechsplit")
    assert sorted(want_params) == sorted(rank0["params"])
    for key, ref in want_params.items():
        np.testing.assert_allclose(rank0["params"][key].numpy(),
                                   ref.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


def test_rank0_checkpoint_loads_everywhere(tmp_path):
    """``cli.train --num_devices 2`` on the CPU: rank 0's ``.ckpt`` has
    a one-process run's names (no DDP ``module.`` prefix), loads
    strictly into a one-process model and through JAX's interop into
    JAX's parameter tree, and holds the one-process run's parameters
    within the mesh bar (the Solver fed each rank its rows of the same
    global batches)."""
    tree = write_feature_tree(str(tmp_path / "feats"), 3, 2, seed=1)
    two, one = tmp_path / "two", tmp_path / "one"
    assert cli_train.main(_cli_args(two, tree, "--device", "cpu",
                                    "--num_devices", "2")) is None
    state = cli_train.main(_cli_args(one, tree, "--device", "cpu"))
    assert os.listdir(two / "models") == os.listdir(one / "models") == [
        "2-G.ckpt"]
    raw = {label: torch.load(path / "models" / "2-G.ckpt",
                             map_location="cpu", weights_only=True)
           for label, path in (("two", two), ("one", one))}
    assert sorted(raw["two"]["model"]) == sorted(raw["one"]["model"])
    assert raw["two"]["step"] == raw["one"]["step"] == 2
    model = SpeechSplit(CFG)
    model.load_state_dict(raw["two"]["model"], strict=True)
    for key, value in state.model.state_dict().items():
        np.testing.assert_allclose(raw["two"]["model"][key].numpy(),
                                   value.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)
    jparams = jax_interop.load_reference_checkpoint(
        str(two / "models" / "2-G.ckpt"))
    want = jax_interop.load_reference_checkpoint(
        str(one / "models" / "2-G.ckpt"))
    assert jax.tree.structure(jparams) == jax.tree.structure(want)
    rngs = {"params": KEY, "resample": KEY}
    want = jax.eval_shape(JaxSpeechSplit(JCFG).init, rngs,
                          jnp.zeros((1, T, CFG.dim_freq + CFG.dim_f0)),
                          jnp.zeros((1, T, CFG.dim_freq)),
                          jnp.zeros((1, CFG.dim_spk_emb)))["params"]
    assert jax.tree.map(np.shape, jparams) == jax.tree.map(
        lambda x: x.shape, want)


def test_a_failing_rank_fails_the_launch():
    """A rank that raises ends the others (the waiting rank is
    terminated) and ``launch`` raises its error."""
    with pytest.raises(Exception, match="rank one fails"):
        parallel.launch(workers.raise_on_rank_one, 2, device="cpu",
                        timeout=TIMEOUT_S, threads=1)


def test_num_devices_counts_as_jax_does(monkeypatch):
    """``--num_devices``: 0 is every visible card, or one process on the
    CPU; NCCL past the visible cards raises naming their count; in a
    launched world (``WORLD_SIZE``) 0 or its size."""
    def world(*flags):
        return cli_train._world_size(cli_train._parser().parse_args(
            list(flags)), cli_train._env_world())

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert world("--device", "cpu") == 1
    assert world("--device", "cpu", "--num_devices", "2") == 2
    assert world() == 3
    assert world("--num_devices", "2") == 2
    with pytest.raises(ValueError, match="3 CUDA device"):
        world("--num_devices", "4")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert world("--device", "cpu") == 2
    with pytest.raises(ValueError, match="world of 2"):
        world("--num_devices", "3")


def test_one_process_needs_no_group(monkeypatch):
    """With no ``WORLD_SIZE`` and no arguments ``initialize`` stays
    single-process; the helpers read a world of one; a mesh needs a
    group; ``mesh_shape`` must be one ``data`` axis of the world."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    assert parallel.initialize(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (parallel.world(), parallel.rank(), parallel.is_primary()) == (
        1, 0, True)
    assert parallel.local_batch_slice(8) == slice(0, 8)
    parallel.barrier()
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh()
    parallel.check_mesh_shape((2,), ("data",), 2)
    for shape, axes in (((2, 4), ("data", "model")), ((1,), ("data",)),
                        ((2,), ("model",))):
        with pytest.raises(ValueError, match="mesh_shape"):
            parallel.check_mesh_shape(shape, axes, 2)
    mesh = parallel.Mesh(size=2, rank=1)
    assert mesh.rows(8) == slice(4, 8)
    assert mesh.example_ids(4).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="split"):
        mesh.rows(5)


def test_example_ids_take_rows_of_the_global_draws():
    """A rank's draws are its rows of the global batch's, and the
    generator moves as the global batch's draws move it; with no
    ``example_ids`` the draws are ``[B, S]`` as before."""
    x = torch.rand(2, T, 3, generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([T, T - 5])
    kwargs = dict(min_len_seg=CFG.min_len_seg, max_len_seg=CFG.max_len_seg,
                  max_len_seq=CFG.max_len_seq, max_len_pad=T)
    whole = torch.Generator().manual_seed(5)
    scales, len_seg = interp.draw_segments(
        4, whole, min_len_seg=CFG.min_len_seg, max_len_seg=CFG.max_len_seg,
        max_len_seq=CFG.max_len_seq)
    want = interp.resample_fixed(x, lengths, scales[2:], len_seg[2:],
                                 max_len_pad=T, seg_span=2 * CFG.max_len_seg)
    gen = torch.Generator().manual_seed(5)
    got = interp.random_resample(x, lengths, gen, example_ids=torch.tensor(
        [2, 3]), global_batch=4, **kwargs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(gen.get_state(), whole.get_state())
    plain, again = (torch.Generator().manual_seed(5) for _ in range(2))
    s2, l2 = interp.draw_segments(
        2, again, min_len_seg=CFG.min_len_seg, max_len_seg=CFG.max_len_seg,
        max_len_seq=CFG.max_len_seq)
    torch.testing.assert_close(
        interp.random_resample(x, lengths, plain, **kwargs),
        interp.resample_fixed(x, lengths, s2, l2, max_len_pad=T,
                              seg_span=2 * CFG.max_len_seg), rtol=0, atol=0)
    with pytest.raises(ValueError, match="global_batch"):
        interp.random_resample(x, lengths, gen, example_ids=torch.tensor(
            [0, 1]), **kwargs)
