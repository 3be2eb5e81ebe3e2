"""The neural vocoder's trainer (``vocoder_neural.py`` training half,
``cli.train_vocoder``) against the JAX package's, on crops of two
speech-like utterances (one of 129 frames, one of 10, shorter than a
crop, so that crops read past its end).

Bars:
- both losses within 1e-5 relative of JAX's on the same signals;
- ``make_crops`` and the resident gather bit for bit;
- the gradient of the full-width loss (the shipped asset, B2, crop 16),
  taken as ``VocoderTrainer.step`` takes it: the loss within 1e-5
  relative. The float32 gradient of this loss is ill-conditioned: the
  log-magnitude terms divide by bins of magnitude near 1e-5 whose
  direction z/|z| is rounding (the float32 gradient lies up to 0.13 of a
  tensor's largest value from float64's on some crops). So the
  gradients (all parameters as one vector, relative L2) are held to
  JAX's own float32 distance from the exact gradient, which the port's
  float32 path does not touch: JAX's float32 gradient within
  ``GRAD_JAX_NOISE`` of the port's float64 one (a wrong term would put
  that far away); the port's float32 gradient from its float64 one
  within ``GRAD_TIMES`` times JAX's distance, and from JAX's within
  their sum (measured 0.00217, 0.00378 and 0.00595). The model's
  backward alone, on a seeded cotangent, is smooth and held so at
  ``BACKWARD_JAX_NOISE`` (measured 9.87e-6, 1.07e-5 and 5.60e-6);
- the port's ``Adam`` with a schedule and weight decay against optax's
  ``adamw`` on seeded float32 parameters and gradients: equal, at lr
  2e-4 (where the decay is below float32's resolution) and at lr 0.5
  (where it shows: the same steps without it differ); fed JAX's
  gradients of the full-width vocoder, after n updates each tensor
  within n float32 ulps at its largest magnitude (measured: one ulp at
  most, 1.49e-8; a rounding of an update shows as many ulps of a
  parameter near zero);
- the trainer's own 4 steps (``total_steps=20``: warmup 2, so the first
  update has lr 0): step 0 leaves every parameter as it was; steps 0
  and 1 (on equal parameters) give JAX's loss within 1e-5, steps 2 and
  3 (after one real update, then two) within ``STEP_LOSS_TOL``; after 4
  steps the parameters' moves within ``MOVE_TOL`` of JAX's (relative
  L2) and each parameter within 2 x the sum of the steps' learning
  rates of JAX's. Adam moves an element by about lr_t a step whatever
  its gradient's size, so an element whose gradient is rounding noise
  may move the other way in the other package (measured 4.79e-4
  against the bar's 9.97e-4, and moves 0.44 apart); with the update's
  sign flipped the losses of steps 2 and 3 are 0.082 and 0.32 apart and
  the moves 1.91.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.io import wavfile

from speechsplit_tpu import vocoder_neural as jvn
from speechsplit_tpu_torch import vocoder_neural as vn
from speechsplit_tpu_torch.cli import train_vocoder as cli_train_vocoder
from speechsplit_tpu_torch.ops.stft import mel_spectrogram
from tests.speech_stimuli import default_utterance

HOP = 256
CROP = 16
BATCH = 2
TOTAL = 20
STEPS = 4
# the gradient (relative L2 over all parameters): JAX's float32 one
# from the port's float64 one (measured 0.00217), and the port's float32
# one from its float64 one, as a multiple of JAX's (measured 1.74)
GRAD_JAX_NOISE = 0.005
# the same for the model's backward alone on a seeded cotangent (measured
# 9.87e-6; the port's 1.07e-5, and 5.60e-6 from JAX's)
BACKWARD_JAX_NOISE = 5e-5
GRAD_TIMES = 3.0
# 4 trainer steps against JAX's: the loss after one real update and
# after two, relative (measured 7.7e-5 and 5.0e-3; with the update's
# sign flipped 0.082 and 0.32), and the parameters' moves over the 4
# steps, relative L2 (measured 0.44; flipped 1.91)
STEP_LOSS_TOL = (1e-3, 2e-2)
MOVE_TOL = 0.75


def _flat(tree, prefix=""):
    """A flax param tree as ``/``-joined keys -> float32 numpy."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, name))
        else:
            out[name] = np.asarray(value, np.float32)
    return out


def _tree(flat):
    out = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    return out


@pytest.fixture(scope="module")
def corpus():
    """Two utterances (32,768 and 2,500 samples) and their mels."""
    wavs = [default_utterance(3, 120.0).wav[:32768].astype(np.float32),
            default_utterance(4, 200.0).wav[:2500].astype(np.float32)]
    mels = [mel_spectrogram(torch.from_numpy(w[None]))[0].numpy()
            for w in wavs]
    assert [len(m) for m in mels] == [129, 10]
    return wavs, mels


def _crops(corpus, seed):
    wavs, mels = corpus
    return vn.make_crops(wavs, mels, BATCH, CROP, HOP,
                         np.random.RandomState(seed))


def _asset_model():
    return vn.load_vocoder("default", device="cpu").model


@pytest.fixture(scope="module")
def jax_run(corpus):
    """JAX's trainer from the asset, ``total_steps=20``: each step's
    crops, loss and gradient (flat keys) and the parameters after it."""
    trainer = jvn.VocoderTrainer(total_steps=TOTAL)
    params = _tree(_flat(jvn._load_npz_params(jvn.default_checkpoint())))
    opt_state = trainer.tx.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(trainer.loss_fn))
    steps = [dict(params=_flat(params))]
    for i in range(STEPS):
        mel, wav = _crops(corpus, i)
        loss, grads = value_and_grad(params, jnp.asarray(mel),
                                     jnp.asarray(wav))
        updates, opt_state = trainer.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append(dict(mel=mel, wav=wav, loss=float(loss),
                          grads=_flat(grads), params=_flat(params)))
    return steps


def test_losses_equal_jax(corpus):
    """Both losses on the asset's waveforms of two crops against the
    crops' own audio (items of unequal energy, so a mean of per-item
    spectral-convergence norms would differ from the one batch norm)."""
    mel, wav = _crops(corpus, 7)
    with torch.no_grad():
        pred = _asset_model()(torch.from_numpy(mel)).numpy()
    pred[1] *= 3.0
    basis = vn.mel_basis(16000, 1024, 80, 90.0, 7600.0, "cpu")
    got = [float(vn.multi_resolution_stft_loss(torch.from_numpy(pred),
                                               torch.from_numpy(wav))),
           float(vn.mel_db_l1(torch.from_numpy(pred), torch.from_numpy(wav),
                              basis, 1024, HOP))]
    want = [float(jvn.multi_resolution_stft_loss(jnp.asarray(pred),
                                                 jnp.asarray(wav))),
            float(jvn.mel_db_l1(jnp.asarray(pred), jnp.asarray(wav),
                                jnp.asarray(basis.numpy()), 1024, HOP))]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    per_item = np.mean([float(vn.multi_resolution_stft_loss(
        torch.from_numpy(pred[i : i + 1]), torch.from_numpy(wav[i : i + 1])))
        for i in range(BATCH)])
    assert abs(per_item - got[0]) > 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_crops_equal_jax_and_the_resident_gather(corpus, seed):
    """``make_crops`` equals JAX's bit for bit; the resident gather, given
    the same (utterance, start) picks, equals it too, zeros past the
    short utterance's end included."""
    wavs, mels = corpus
    want = jvn.make_crops(wavs, mels, 8, CROP, HOP,
                          np.random.RandomState(seed))
    got = vn.make_crops(wavs, mels, 8, CROP, HOP,
                        np.random.RandomState(seed))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    rng = np.random.RandomState(seed)  # the picks make_crops drew
    picks = []
    for _ in range(8):
        j = rng.randint(0, len(wavs))
        picks.append((j, rng.randint(0, max(len(mels[j]) - CROP, 0) + 1)))
    resident = vn.ResidentCorpus(wavs, mels, CROP, HOP, "cpu")
    uid, start = (torch.tensor(c) for c in zip(*picks))
    for g, w in zip(resident.gather(uid, start), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_resident_draws_stay_in_range(corpus):
    wavs, mels = corpus
    resident = vn.ResidentCorpus(wavs, mels, CROP, HOP, "cpu")
    gen = torch.Generator().manual_seed(0)
    mel, wav = resident.draw(64, gen)
    assert mel.shape == (64, CROP, 80) and wav.shape == (64, (CROP - 1) * HOP)
    again = resident.draw(64, torch.Generator().manual_seed(0))
    torch.testing.assert_close(again[0], mel, rtol=0, atol=0)
    # a crop of the short utterance is its 10 frames and zeros
    short = (mel[:, 10:] == 0).all(dim=(1, 2)) & (mel[:, :10] != 0).any(
        dim=(1, 2))
    assert 0 < int(short.sum()) < 64


def test_init_matches_jax_layers():
    """The port's initializers against a JAX init of the same model:
    every kernel Xavier-uniform (|w| <= sqrt(6 / (fan_in + fan_out)),
    std within 3% of JAX's), every bias within +-1/sqrt(fan_in) and
    zero-mean, LayerNorms at 1 and 0."""
    port = vn.state_dict_to_npz(vn.init_model(
        torch.Generator().manual_seed(0)).state_dict())
    want = _flat(jvn.NeuralVocoderModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, CROP, 80)))["params"])
    assert sorted(port) == sorted(want)
    for key, w in want.items():
        got = port[key]
        assert got.shape == w.shape, key
        layer, leaf = key.rsplit("/", 1)
        kernel = want.get(layer + "/kernel")
        if kernel is None:  # a LayerNorm
            np.testing.assert_array_equal(got, w)
            continue
        k = kernel.shape[0] if kernel.ndim == 3 else 1
        fan_in, fan_out = k * kernel.shape[-2], k * kernel.shape[-1]
        bound = (np.sqrt(6.0 / (fan_in + fan_out)) if leaf == "kernel"
                 else 1.0 / np.sqrt(fan_in))
        for x in (got, w):
            assert np.abs(x).max() <= bound * (1 + 1e-6), key
            assert abs(x.mean()) <= 4 * bound / np.sqrt(3 * x.size), key
        assert abs(got.std() / w.std() - 1) <= 0.03 + 3 / np.sqrt(got.size)
    assert not np.array_equal(port["backbone/embed/kernel"],
                              vn.state_dict_to_npz(vn.init_model(
                                  torch.Generator().manual_seed(1))
                                  .state_dict())["backbone/embed/kernel"])


def test_schedule_equals_optax():
    for total in (20, 4, 6000):
        want = optax.warmup_cosine_decay_schedule(
            0.0, 2e-4, warmup_steps=min(500, total // 10), decay_steps=total,
            end_value=0.05 * 2e-4)
        got = vn.warmup_cosine_lr(2e-4, total)
        counts = list(range(0, min(total, 30))) + [total - 1, total, total + 7]
        np.testing.assert_allclose([got(c) for c in counts],
                                   [float(want(c)) for c in counts],
                                   rtol=1e-6, atol=0)
        assert got(0) == (0.0 if total >= 10 else float(np.float32(2e-4)))
    assert vn.VocoderTrainer(total_steps=0, device="cpu").lr == 2e-4


def _grads(trainer, model, mel, wav, dtype=np.float32):
    """The loss and its gradient as ``VocoderTrainer.step`` takes them
    (flat keys, in ``dtype``)."""
    loss = trainer.loss_and_grad(model, torch.from_numpy(mel),
                                 torch.from_numpy(wav))
    return float(loss), vn.state_dict_to_npz(
        {k: p.grad for k, p in model.named_parameters()}, dtype)


def _rel_l2(got, want):
    """|got - want| / |want| over all parameters as one vector."""
    diff = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
               for k in want)
    norm = sum(float(np.sum(np.asarray(want[k], np.float64) ** 2))
               for k in want)
    return (diff / norm) ** 0.5


def test_loss_and_gradients_equal_jax(jax_run):
    first = jax_run[1]
    trainer = vn.VocoderTrainer(total_steps=TOTAL, device="cpu")
    loss, got = _grads(trainer, _asset_model(), first["mel"], first["wav"])
    assert abs(loss - first["loss"]) <= 1e-5 * first["loss"]
    assert sorted(got) == sorted(first["grads"])
    _, exact = _grads(trainer, _asset_model().double(), first["mel"],
                      first["wav"], np.float64)
    jax_noise = _rel_l2(first["grads"], exact)
    port_noise = _rel_l2(got, exact)
    err = _rel_l2(got, first["grads"])
    # the port's float64 gradient is JAX's float32 one within float32
    # noise: a wrong term would put it far away
    assert jax_noise <= GRAD_JAX_NOISE, jax_noise
    # the port's float32 gradient is as near the exact one as JAX's,
    # within a factor; so the two are within the sum of their distances
    assert port_noise <= GRAD_TIMES * jax_noise, (port_noise, jax_noise)
    assert err <= (1 + GRAD_TIMES) * jax_noise, (err, jax_noise)


def test_model_backward_equals_jax(jax_run):
    """The model's backward alone (no loss: a seeded cotangent on its
    waveform), a smooth map, so a sharp bar: JAX's float32 result within
    ``GRAD_JAX_NOISE`` of the port's float64 one, the port's float32
    one within ``GRAD_TIMES`` times JAX's distance of it, and of JAX's
    within their sum."""
    first = jax_run[1]
    params = _tree(jax_run[0]["params"])
    model = jvn.VocoderTrainer(total_steps=TOTAL).model
    pred, vjp = jax.vjp(lambda p: model.apply({"params": p},
                                              jnp.asarray(first["mel"])),
                        params)
    cotangent = np.random.RandomState(5).randn(*pred.shape)
    want = _flat(vjp(jnp.asarray(cotangent, jnp.float32))[0])
    got = {}
    for dtype in (torch.float32, torch.float64):
        m = _asset_model().to(dtype)
        out = m(torch.from_numpy(first["mel"]).to(dtype))
        assert tuple(out.shape) == pred.shape
        out.backward(torch.from_numpy(cotangent).to(dtype))
        got[dtype] = vn.state_dict_to_npz(
            {k: p.grad for k, p in m.named_parameters()}, np.float64)
    exact = got[torch.float64]
    jax_noise = _rel_l2(want, exact)
    port_noise = _rel_l2(got[torch.float32], exact)
    err = _rel_l2(got[torch.float32], want)
    assert jax_noise <= BACKWARD_JAX_NOISE, jax_noise
    assert port_noise <= GRAD_TIMES * jax_noise, (port_noise, jax_noise)
    assert err <= (1 + GRAD_TIMES) * jax_noise, (err, jax_noise)


def test_adam_with_schedule_and_decay_equals_optax_adamw():
    """optax's order: -lr_t (adam_t + wd p), lr_t read at the count of
    earlier updates (0 for the first: no move)."""
    rng = np.random.RandomState(0)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, 2e-4, warmup_steps=2, decay_steps=TOTAL, end_value=1e-5),
        weight_decay=1e-4)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = vn.Adam(tparams, lr=vn.warmup_cosine_lr(2e-4, TOTAL),
                  weight_decay=vn.WEIGHT_DECAY)
    for step in range(6):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads],
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, want, first in zip(tparams, jparams, params):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(want))
            if step == 0:
                np.testing.assert_array_equal(np.asarray(want), first)


def test_adam_weight_decay_equals_optax_adamw_where_it_shows():
    """At lr 2e-4 the decay, lr wd = 2e-8 of a parameter, is below
    float32's resolution and rounds away; at lr 0.5 (a schedule, as the
    trainer's) it is 5e-5 of a parameter, some 400 ulps: after n steps
    the port's parameters are within n ulps of optax's ``adamw`` (the
    port adds wd p to the update in one rounding, optax in two), and
    without the decay they would be hundreds of ulps away."""
    rng = np.random.RandomState(1)
    shapes = [(9, 4), (13,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = optax.adamw(optax.constant_schedule(0.5), weight_decay=1e-4)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    got = {}
    for decay in (vn.WEIGHT_DECAY, 0.0):
        tparams = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                   for p in params]
        opt = vn.Adam(tparams, lr=lambda count: 0.5, weight_decay=decay)
        for g in grads:
            for p, x in zip(tparams, g):
                p.grad = torch.from_numpy(x)
            opt.step()
        got[decay] = [p.detach().numpy() for p in tparams]
    for decay, ulps in ((vn.WEIGHT_DECAY, (0, len(grads))),
                        (0.0, (100, np.inf))):
        for p, want in zip(got[decay], jparams):
            want = np.asarray(want)
            off = np.abs(p - want).max() / np.spacing(np.abs(want).max())
            assert ulps[0] <= off <= ulps[1], (decay, off)


def test_optimizer_fed_jax_gradients_equals_adamw(jax_run):
    model = _asset_model()
    state = vn.VocoderTrainer(total_steps=TOTAL, device="cpu").state_from(
        model)
    names = dict(model.named_parameters())
    for updates, step in enumerate(jax_run[1:]):  # the first has lr 0
        grads = vn.npz_to_state_dict(step["grads"])
        for name, p in names.items():
            p.grad = grads[name].clone()
        state.optimizer.step()
        got = vn.state_dict_to_npz(model.state_dict())
        for key, want in step["params"].items():
            ulp = np.spacing(np.abs(want).max())
            assert np.abs(got[key] - want).max() <= updates * ulp, key


def test_trainer_steps_follow_jax(jax_run):
    trainer = vn.VocoderTrainer(total_steps=TOTAL, device="cpu")
    state = trainer.state_from(_asset_model())
    start = vn.state_dict_to_npz(state.model.state_dict())
    for key, want in jax_run[0]["params"].items():
        np.testing.assert_array_equal(start[key], want)
    for i, step in enumerate(jax_run[1:]):
        state, loss = trainer.step(state, torch.from_numpy(step["mel"]),
                                   torch.from_numpy(step["wav"]))
        assert state.step == i + 1
        got = vn.state_dict_to_npz(state.model.state_dict())
        if i == 0:  # lr 0: no parameter moves
            for key in got:
                np.testing.assert_array_equal(got[key], start[key])
                np.testing.assert_array_equal(step["params"][key], start[key])
        if i < 2:  # on the starting parameters (the first update is 0)
            assert abs(float(loss) - step["loss"]) <= 1e-5 * step["loss"]
        else:  # after one real update, then two
            tol = STEP_LOSS_TOL[i - 2]
            assert abs(float(loss) - step["loss"]) <= tol * step["loss"], i
    assert state.optimizer.param_groups[0]["weight_decay"] == 1e-4
    bar = 2 * sum(trainer.lr(c) for c in range(STEPS))
    want = jax_run[-1]["params"]
    worst = max(float(np.abs(got[k] - w).max()) for k, w in want.items())
    moved = {k: got[k].astype(np.float64) - start[k] for k in want}
    want_moved = {k: want[k].astype(np.float64) - start[k] for k in want}
    assert _rel_l2(moved, want_moved) <= MOVE_TOL
    assert 0 < worst <= bar, (worst, bar)


def test_save_and_export_equal_jax(tmp_path):
    """``save_vocoder`` writes ``{path}.npz`` that JAX's ``load_vocoder``
    and the port's read (float32, the architecture from the shapes);
    ``export_vocoder_npz`` writes JAX's float16 export of the same
    weights."""
    model = vn.init_model(torch.Generator().manual_seed(3), channels=16,
                          depth=2)
    path = vn.save_vocoder(str(tmp_path / "8-V"), model)
    assert path == str(tmp_path / "8-V.npz") and os.path.isfile(path)
    flat = vn.state_dict_to_npz(model.state_dict())
    jax_vocoder = jvn.load_vocoder(path)
    assert (jax_vocoder.model.channels, jax_vocoder.model.depth) == (16, 2)
    jparams = _flat(jax_vocoder.params)
    assert sorted(jparams) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(jparams[key], value)
    port = vn.load_vocoder(path, device="cpu")
    for key, value in model.state_dict().items():
        torch.testing.assert_close(port.model.state_dict()[key], value,
                                   rtol=0, atol=0)
    got = vn.export_vocoder_npz(str(tmp_path / "port.npz"), model)
    want = jvn.export_vocoder_npz(str(tmp_path / "jax.npz"),
                                  jvn._load_npz_params(path))
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for key in w.files:
            assert g[key].dtype == w[key].dtype == np.float16
            np.testing.assert_array_equal(g[key], w[key])


def _wav_tree(root, corpus):
    wavs, _ = corpus
    for spk, wav in zip(("a", "b"), wavs):
        os.makedirs(os.path.join(root, spk))
        wavfile.write(os.path.join(root, spk, "0.wav"), 16000,
                      (wav * 32767).astype(np.int16))


def _cli_args(wav_dir, save_dir, *extra):
    return ["--wav_dir", wav_dir, "--save_dir", save_dir,
            "--num_iters", "4", "--steps_per_dispatch", "2",
            "--batch_size", "2", "--crop_frames", "16", "--channels", "16",
            "--depth", "2", "--log_step", "2", "--save_step", "4",
            "--device", "cpu", *extra]


def test_cli_train_vocoder_on_cpu(tmp_path, corpus):
    wav_dir, save_dir = str(tmp_path / "wavs"), str(tmp_path / "run")
    _wav_tree(wav_dir, corpus)
    state, logged = cli_train_vocoder.main(_cli_args(wav_dir, save_dir))
    assert state.step == 4
    assert [i for i, _ in logged] == [2, 4]
    assert all(np.isfinite(loss) for _, loss in logged)
    assert os.listdir(save_dir) == ["4-V.npz"]
    vocoder = vn.load_vocoder(os.path.join(save_dir, "4-V.npz"),
                              device="cpu")
    _, mels = corpus
    pcm = vocoder.synthesize_batch([mels[0][:40]], pcm16=True)[0]
    assert pcm.dtype == np.int16 and len(pcm) == 39 * HOP
    with pytest.raises(FloatingPointError, match="loss"):
        cli_train_vocoder.main(_cli_args(
            wav_dir, str(tmp_path / "nan"), "--learning_rate", "1e30"))
