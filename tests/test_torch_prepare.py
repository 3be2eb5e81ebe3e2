"""The port's corpus preparation (``data/prepare.py``, ``cli.preprocess``,
``cli.metadata``) against the JAX package's on one small wav tree: two
speakers (p225 M, p226 F) x three speech-like wavs of 5,000-15,000
samples. At ``batch_size=2`` and ``batches_per_dispatch=2`` the sorted
corpus makes three batches, one of 8,192 samples and two of 16,384: a
group cut short by the shape break (one batch, filled up with a repeat)
and a full one.

The dither: JAX draws it from ``PRNGKey(seed)``, split a group and
folded in a batch (prepare.py:285, preprocess.py:240); the port takes
those draws through ``extract_dir(dither=...)`` (PARITY #3).

Bars, those of tests/test_torch_preprocess.py: mel within 1e-5; F0
voicing on 99.5% of the frames; the normalized F0 within 1e-5 with the
last-frame limit. An utterance's last frame takes its lag from FFT
rounding in JAX (ROADMAP.md C, limits), and through the speaker
normalization's mean and std a difference there moves all of the
utterance's values by one affine map (here the last frames differ by
8.5e-5 to 0.741 log-F0, an octave, and the map's slope by up to 0.35).
So the two packages' raw log-F0 tracks on each batch are held equal
(1e-5, voicing exact) on every frame but each utterance's last; the
port's file is its own track normalized, exactly, and so within 1e-5
of JAX's track normalized with the port's last frame; JAX's file is
within 1e-5 of JAX's track normalized with one last frame, the value
that fits it best (its compiled tracker rounds apart from the unjitted
one there). Where the two last frames agree (two of the six, both
unvoiced) the F0 is within 1e-5 of JAX's frame for frame.
"""

import os
import pickle
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch
from scipy.io import wavfile

from speechsplit_tpu.data import prepare as jprepare
from speechsplit_tpu.ops import pitch as jpitch
from speechsplit_tpu_torch.cli import metadata as cli_metadata
from speechsplit_tpu_torch.cli import preprocess as cli_preprocess
from speechsplit_tpu_torch.cli import train as cli_train
from speechsplit_tpu_torch.data import prepare
from speechsplit_tpu_torch.ops import pitch
from speechsplit_tpu_torch.preprocess import extract_features, normalize_log_f0
from tests.speech_stimuli import default_utterance
from tests.test_torch_data import CFG

LENGTHS = {"p225": (5000, 7000, 12000), "p226": (6000, 9000, 15000)}
SPK2GEN = {"p225": "M", "p226": "F"}
SEED = 3
STAGING = dict(batch_size=2, batches_per_dispatch=2)
SENTINEL = -1e10  # UNVOICED_LOG_F0


def jax_dither(seed):
    """JAX extract_dir's draws as the port's hook: group g's key is the
    g-th ``split`` of ``PRNGKey(seed)``, batch k's draws
    ``uniform(fold_in(sub, k), [B, N])``."""
    key, subs = [jax.random.PRNGKey(seed)], []

    def draws(group, k, shape):
        while len(subs) <= group:
            key[0], sub = jax.random.split(key[0])
            subs.append(sub)
        return np.asarray(jax.random.uniform(
            jax.random.fold_in(subs[group], k), shape))

    return draws


def _write_wavs(root):
    for i, (spk, lengths) in enumerate(LENGTHS.items()):
        os.makedirs(os.path.join(root, spk))
        for j, n in enumerate(lengths):
            wav = np.resize(default_utterance(3 + 2 * i + j,
                                              120.0 + 80.0 * i).wav, n)
            wavfile.write(os.path.join(root, spk, f"u{j}.wav"), 16000,
                          (wav * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The wav tree and the trees each package extracts from it, plain
    and with ``compress_fetch``."""
    root = str(tmp_path_factory.mktemp("corpus"))
    wav_dir = os.path.join(root, "wavs")
    _write_wavs(wav_dir)
    trees = {}
    for compress in (False, True):
        tag = "c" if compress else ""
        jprepare.extract_dir(
            wav_dir, os.path.join(root, "jax_mel" + tag),
            os.path.join(root, "jax_f0" + tag), SPK2GEN, seed=SEED,
            compress_fetch=compress, **STAGING)
        prepare.extract_dir(
            wav_dir, os.path.join(root, "mel" + tag),
            os.path.join(root, "f0" + tag), SPK2GEN, seed=SEED,
            compress_fetch=compress, device="cpu", dither=jax_dither(SEED),
            **STAGING)
        trees[compress] = {
            name: _read_tree(os.path.join(root, name + tag))
            for name in ("jax_mel", "jax_f0", "mel", "f0")}
    return root, wav_dir, trees


def _read_tree(path):
    return {(spk, f): np.load(os.path.join(path, spk, f))
            for spk in sorted(os.listdir(path))
            if os.path.isdir(os.path.join(path, spk))
            for f in sorted(os.listdir(os.path.join(path, spk)))}


def _tracks(wav_dir):
    """Per file: (n frames, the port's raw log-F0 track, JAX's), each
    package's tracker on its batch's dithered signal (JAX's draws), the
    rows [T] of the padded batch."""
    _, entries = prepare._enumerate_entries(wav_dir, SPK2GEN)
    draws = jax_dither(SEED)
    out = {}
    for g, (group, _) in enumerate(prepare._staged_groups(
            wav_dir, entries, **STAGING)):
        for k, (job, batch, lengths) in enumerate(group):
            uniform = np.array(draws(g, k, batch.shape))
            bounds = (lengths, np.array([e[2] for e in job], np.float32),
                      np.array([e[3] for e in job], np.float32))
            y_t = (torch.from_numpy(batch).float() / 32768.0 * 0.96
                   + (torch.from_numpy(uniform) - 0.5) * 2.0 * 1e-6)
            y_j = (jnp.asarray(batch).astype(jnp.float32) / 32768.0 * 0.96
                   + (jnp.asarray(uniform) - 0.5) * 2.0 * 1e-6)
            own = pitch.track_pitch(y_t, *map(torch.from_numpy, bounds))
            theirs = np.asarray(jpitch.track_pitch(
                y_j, *map(jnp.asarray, bounds)))
            for i, (spk, fname, _lo, _hi) in enumerate(job):
                out[(spk, fname[:-4] + ".npy")] = (
                    int(lengths[i]) // 256 + 1, own[i].numpy(), theirs[i])
    return out


def _normalized(track, n, last):
    """``track`` [T] with frame n-1 set to ``last``, normalized (the
    port's ``normalize_log_f0``, held to JAX's in
    tests/test_torch_preprocess.py), its first n frames."""
    track = track.copy()
    track[n - 1] = last
    return normalize_log_f0(torch.from_numpy(track[None]))[0].numpy()[:n]


def _last_frame_of(f0, track, n):
    """The last frame's log-F0 that, beside ``track``'s other frames,
    gives the normalization in ``f0`` (a file of n frames): the sentinel
    where the file's last frame is unvoiced, else the least-squares
    value, started from the one that makes the voiced frames' mean the
    file's (read from the line f0 = (x - mean) / (8 std) + 1/2 through
    its voiced, unclipped frames but the last)."""
    if f0[n - 1] < -1e9:
        return SENTINEL
    x, y = track[:n].astype(np.float64), f0.astype(np.float64)
    use = (x > -1e9) & (y > 0) & (y < 1)
    use[n - 1] = False
    slope, intercept = np.polyfit(x[use], y[use], 1)
    voiced = x[: n - 1][x[: n - 1] > -1e9]
    start = (0.5 - intercept) / slope * (len(voiced) + 1) - voiced.sum()

    def misfit(v):
        z = np.append(voiced, v)
        norm = np.clip((x - z.mean()) / z.std() / 4.0, -1.0, 1.0)
        norm[n - 1] = np.clip((v - z.mean()) / z.std() / 4.0, -1.0, 1.0)
        return float(np.sum(((norm + 1.0) / 2.0 - y)[x > -1e9] ** 2))

    return scipy.optimize.minimize_scalar(
        misfit, bounds=(start - 0.1, start + 0.1), method="bounded",
        options={"xatol": 1e-9}).x


def test_walk_and_staged_groups_equal_jax(corpus):
    _, wav_dir, _ = corpus
    assert prepare.list_wavs(wav_dir) == jprepare.list_wavs(wav_dir)
    for path in prepare.list_wavs(wav_dir):
        assert prepare.wav_frame_count(path) == jprepare.wav_frame_count(path)
    got = prepare._enumerate_entries(wav_dir, SPK2GEN)
    want = jprepare._enumerate_entries(wav_dir, SPK2GEN)
    assert got == want
    groups = list(prepare._staged_groups(wav_dir, got[1], **STAGING))
    jgroups = list(jprepare._staged_groups(wav_dir, want[1], **STAGING))
    assert [k for _, k in groups] == [k for _, k in jgroups] == [1, 2]
    for (group, k_real), (jgroup, _) in zip(groups, jgroups):
        # JAX fills a short group up with repeats; the port does not
        assert len(group) == k_real and len(jgroup) == 2
        for (job, batch, lengths), (jjob, jbatch, jlengths) in zip(
                group, jgroup[:k_real]):
            assert job == jjob
            assert batch.dtype == jbatch.dtype == np.int16
            np.testing.assert_array_equal(batch, jbatch)
            np.testing.assert_array_equal(lengths, jlengths)
    assert [g[0][1].shape[1] for g, _ in groups] == [8192, 16384]


def test_extract_dir_trees_equal_jax(corpus):
    _, wav_dir, trees = corpus
    tracks = _tracks(wav_dir)
    t = trees[False]
    assert sorted(t["mel"]) == sorted(t["jax_mel"]) == sorted(t["f0"])
    checked = 0
    voiced_same = []
    for key, mel in t["mel"].items():
        want_mel, f0, want_f0 = t["jax_mel"][key], t["f0"][key], t["jax_f0"][
            key]
        assert mel.dtype == f0.dtype == np.float32
        assert mel.shape == want_mel.shape and f0.shape == want_f0.shape
        assert mel.shape == (f0.shape[0], 80)
        np.testing.assert_allclose(mel, want_mel, rtol=0, atol=1e-5)
        voiced_same.append((f0 > -1e9) == (want_f0 > -1e9))
        n, own, theirs = tracks[key]
        assert n == len(f0)
        # the trackers agree but on the last frame (ROADMAP.md C)
        np.testing.assert_array_equal(own[: n - 1] > -1e9,
                                      theirs[: n - 1] > -1e9)
        np.testing.assert_allclose(own[: n - 1], theirs[: n - 1], rtol=0,
                                   atol=1e-5)
        assert (own[n:] < -1e9).all() and (theirs[n:] < -1e9).all()
        # the port's file is its track normalized, and so JAX's track
        # with the port's last frame
        np.testing.assert_array_equal(f0, _normalized(own, n, own[n - 1]))
        np.testing.assert_allclose(f0, _normalized(theirs, n, own[n - 1]),
                                   rtol=0, atol=1e-5)
        # JAX's file is JAX's track with one last frame (its compiled
        # tracker's, which rounds apart from the unjitted one's there)
        last = _last_frame_of(want_f0, theirs, n)
        np.testing.assert_allclose(want_f0, _normalized(theirs, n, last),
                                   rtol=0, atol=1e-5)
        if abs(own[n - 1] - last) <= 1e-5:
            np.testing.assert_allclose(f0, want_f0, rtol=0, atol=1e-5)
            checked += 1
    assert np.concatenate(voiced_same).mean() >= 0.995
    assert checked == 2


def test_extract_dir_equals_extract_features_on_its_batches(corpus):
    """The pipeline (staging, trimming, writing) adds nothing: each file
    equals ``extract_features`` on its batch with the same draws."""
    _, wav_dir, trees = corpus
    _, entries = prepare._enumerate_entries(wav_dir, SPK2GEN)
    draws = jax_dither(SEED)
    for g, (group, _) in enumerate(prepare._staged_groups(
            wav_dir, entries, **STAGING)):
        for k, (job, batch, lengths) in enumerate(group):
            mel, f0 = extract_features(
                batch, lengths, [e[2] for e in job], [e[3] for e in job],
                uniform=torch.from_numpy(np.array(draws(g, k, batch.shape))),
                device="cpu")
            for i, (spk, fname, _lo, _hi) in enumerate(job):
                n = lengths[i] // 256 + 1
                key = (spk, fname[:-4] + ".npy")
                np.testing.assert_array_equal(trees[False]["mel"][key],
                                              mel[i, :n].numpy())
                np.testing.assert_array_equal(trees[False]["f0"][key],
                                              f0[i, :n].numpy())


def _bf16_ulp(x):
    """One bfloat16 ulp at each value's magnitude."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_compress_fetch_is_one_bfloat16_ulp_from_jax(corpus):
    """bfloat16 features: each value the bfloat16 nearest the port's
    float32 one, within one bfloat16 ulp of JAX's, the unvoiced sentinel
    exactly JAX's (the bfloat16 nearest -1e10)."""
    _, _, trees = corpus
    t, plain = trees[True], trees[False]
    sentinel = float(torch.tensor(SENTINEL).to(torch.bfloat16).float())
    for key, mel in t["mel"].items():
        f0, want_mel, want_f0 = t["f0"][key], t["jax_mel"][key], t["jax_f0"][
            key]
        assert mel.dtype == f0.dtype == np.float32
        for got, full in ((mel, plain["mel"][key]), (f0, plain["f0"][key])):
            rounded = torch.from_numpy(full).to(torch.bfloat16).float()
            np.testing.assert_array_equal(got, rounded.numpy())
        assert np.all(np.abs(mel - want_mel) <= _bf16_ulp(want_mel))
        unvoiced = (f0 < -1e9) & (want_f0 < -1e9)
        assert np.all(f0[unvoiced] == sentinel)
        assert np.all(want_f0[unvoiced] == sentinel)
        if np.allclose(plain["f0"][key], plain["jax_f0"][key], rtol=0,
                       atol=1e-5):
            voiced = (f0 > -1e9) & (want_f0 > -1e9)
            assert np.all(np.abs(f0 - want_f0)[voiced]
                          <= _bf16_ulp(want_f0)[voiced])


@pytest.mark.parametrize("stop", ["close", "raise"])
def test_staged_groups_reader_stops_with_its_consumer(corpus, tmp_path, stop):
    """The reader thread ends when the consumer stops early: the
    generator closed after one group, or ``extract_dir`` raising in a
    stage (here the dither hook) while the reader is blocked on its
    full queue."""
    _, wav_dir, _ = corpus
    before = set(threading.enumerate())
    if stop == "close":
        _, entries = prepare._enumerate_entries(wav_dir, SPK2GEN)
        groups = prepare._staged_groups(wav_dir, entries, batch_size=1,
                                        batches_per_dispatch=1)
        next(groups)
        groups.close()
    else:
        def dither(group, k, shape):
            raise RuntimeError("stage failed")

        with pytest.raises(RuntimeError, match="stage failed"):
            prepare.extract_dir(
                wav_dir, str(tmp_path / "mel"), str(tmp_path / "f0"),
                SPK2GEN, batch_size=1, batches_per_dispatch=1,
                device="cpu", dither=dither)
    assert set(threading.enumerate()) <= before


@pytest.mark.parametrize("compat", [False, True])
def test_build_metadata_equals_jax(corpus, compat):
    root, _, _ = corpus
    mel_dir = os.path.join(root, "mel")
    want = jprepare.build_metadata(mel_dir, reference_compat=compat,
                                   out_name="jax.pkl")
    got = prepare.build_metadata(mel_dir, reference_compat=compat)
    with open(os.path.join(mel_dir, "train.pkl"), "rb") as handle:
        assert len(pickle.load(handle)) == len(got)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2:] == w[2:]
        np.testing.assert_array_equal(g[1], w[1])
        assert g[1].dtype == w[1].dtype == np.float32
    slots = [int(np.argmax(entry[1])) for entry in got]
    assert slots == ([7, 1] if compat else [0, 1])
    assert got[0][2:] == [os.path.join("p225", f"u{j}.npy") for j in range(3)]


def test_clis_write_a_corpus_that_cli_train_reads(corpus, tmp_path):
    """``cli.preprocess`` (the genders from a ``spk2gen.pkl``, the rest
    defaulted), ``cli.metadata`` and two steps of ``cli.train --device
    cpu`` on the port's own corpus. The generator seeded from ``--seed``
    draws the dither, so a second run writes the same files."""
    _, wav_dir, _ = corpus
    wavs = str(tmp_path / "wavs")
    shutil.copytree(wav_dir, wavs)
    os.makedirs(os.path.join(wavs, "p227"))
    shutil.copy(os.path.join(wav_dir, "p225", "u0.wav"),
                os.path.join(wavs, "p227", "v0.wav"))
    spk2gen = str(tmp_path / "spk2gen.pkl")
    with open(spk2gen, "wb") as handle:
        pickle.dump(SPK2GEN, handle)
    trees = []
    for run in ("a", "b"):
        mel_dir, f0_dir = str(tmp_path / f"spmel_{run}"), str(
            tmp_path / f"raptf0_{run}")
        done = cli_preprocess.main([
            "--wav_dir", wavs, "--mel_dir", mel_dir, "--f0_dir", f0_dir,
            "--spk2gen", spk2gen, "--default_gender", "F",
            "--batch_size", "2", "--seed", "5", "--device", "cpu"])
        assert done == ["p225", "p226", "p227"]
        trees.append((_read_tree(mel_dir), _read_tree(f0_dir)))
    (mel_a, f0_a), (mel_b, f0_b) = trees
    assert len(mel_a) == 7
    for key in mel_a:
        np.testing.assert_array_equal(mel_a[key], mel_b[key])
        np.testing.assert_array_equal(f0_a[key], f0_b[key])
        assert np.isfinite(mel_a[key]).all()
    meta = cli_metadata.main(["--mel_dir", mel_dir])
    assert [m[0] for m in meta] == ["p225", "p226", "p227"]
    hparams = ",".join(f"{k}={getattr(CFG, k)}" for k in (
        "dim_enc", "dim_enc_2", "dim_enc_3", "dim_neck", "dim_neck_2",
        "dim_neck_3", "dim_dec_mel", "dim_dec_f0", "max_len_pad",
        "max_len_seq", "min_len_seq"))
    state = cli_train.main([
        "--num_iters", "2", "--log_step", "1", "--model_save_step", "2",
        "--sample_step", "1000", "--device", "cpu",
        "--model_save_dir", str(tmp_path / "models"),
        "--sample_dir", str(tmp_path / "samples"),
        "--log_dir", str(tmp_path / "logs"),
        "--validation_path", str(tmp_path / "missing.pkl"),
        "--hparams", f"root_dir={mel_dir},feat_dir={f0_dir},batch_size=2,"
        + hparams])
    assert state.step == 2
    assert os.listdir(tmp_path / "models") == ["2-G.ckpt"]
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
