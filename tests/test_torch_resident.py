"""The port's device-resident training data (``data/resident.py``,
``preprocess.extract_into_store``) against the host loader and the JAX
package's ``data/resident.py``, on one small feature tree and two small
wav trees:

- ``plan_batches`` draws JAX's plans for a seed; ``collate_on_device``
  gives the host loader's batches and JAX's ``collate_on_device``'s, bit
  for bit; a bfloat16 store is JAX's bit for bit, within 4e-3 of the
  float32 store's batch, with the unvoiced sentinel kept;
- the resident step (``[B]`` and ``[2, B]`` plans) is the host step,
  bit for bit, for both models;
- ``build_resident_from_wavs`` (bfloat16, the port's own seeded draws)
  is ``extract_dir(compress_fetch=True)`` -> ``build_metadata`` ->
  ``build_resident`` bit for bit; with JAX's draws injected (PARITY #3)
  it is JAX's store, mel within 1e-5 and F0 under the last-frame rule of
  tests/test_torch_prepare.py (ROADMAP.md C, limits)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.data import dataset as jax_dataset
from speechsplit_tpu.data import resident as jax_resident
from speechsplit_tpu.data.synthetic import make_corpus
from speechsplit_tpu_torch.data import SpeakerDataset, data_loader, prepare
from speechsplit_tpu_torch.data.resident import (
    UNVOICED,
    build_resident,
    build_resident_from_wavs,
    collate_on_device,
    make_resident_train_step,
    plan_batches,
    stack_plans,
)
from speechsplit_tpu_torch.preprocess import extract_into_store
from speechsplit_tpu_torch.training import (
    create_train_state,
    make_f0_train_step,
    make_train_step,
)
from tests.test_torch_data import CFG as TINY
from tests.test_torch_data import JCFG as JTINY
from tests.test_torch_data import write_feature_tree
from tests.test_torch_prepare import (
    SEED,
    SPK2GEN,
    STAGING,
    _last_frame_of,
    _normalized,
    _tracks,
    _write_wavs,
    jax_dither,
)

CFG, JCFG = TINY.replace(batch_size=4), JTINY.replace(batch_size=4)
# float32 residuals and Adam moments for the steps
F32 = CFG.replace(residual_dtype="float32", adam_mu_dtype="float32")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A feature tree of 3 speakers (2, 1 and 3 utterances of 10-60
    frames, some shorter than a crop), read by both packages."""
    root, feat = write_feature_tree(str(tmp_path_factory.mktemp("feats")), 3,
                                    [2, 1, 3], seed=11, frames=(10, 60))
    return (SpeakerDataset(root, feat),
            jax_dataset.SpeakerDataset(root, feat))


def _plans(utts, features, seed=3):
    return plan_batches(utts, features.length.numpy(), CFG, seed=seed)


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


def test_plan_batches_equal_jax(tree):
    dataset, jdataset = tree
    features, utts = build_resident(dataset, CFG, device="cpu")
    jfeatures, jutts = jax_resident.build_resident(jdataset, JCFG)
    assert utts == jutts
    np.testing.assert_array_equal(features.length.numpy(),
                                  np.asarray(jfeatures.length))
    ours = _plans(utts, features)
    theirs = jax_resident.plan_batches(jutts, np.asarray(jfeatures.length),
                                       JCFG, seed=3)
    six = [next(ours) for _ in range(6)]
    for plan in six:
        want = next(theirs)
        for got, ref in zip(plan, want):
            assert got.dtype == ref.dtype == np.int32
            np.testing.assert_array_equal(got, ref)
    stacked = next(stack_plans(iter(six), 2))
    assert stacked.utt.shape == (2, CFG.batch_size)
    np.testing.assert_array_equal(stacked.offset[1], six[1].offset)


def test_collate_equals_the_host_loader_and_jax(tree):
    dataset, jdataset = tree
    features, utts = build_resident(dataset, CFG, device="cpu")
    jfeatures, _ = jax_resident.build_resident(jdataset, JCFG)
    host = data_loader(dataset, CFG, seed=3)
    plans = _plans(utts, features)
    short = 0
    for _ in range(6):
        plan = next(plans)
        got = collate_on_device(CFG, features, plan)
        want = jax_resident.collate_on_device(
            JCFG, jfeatures, jax_resident.Plan(*map(jnp.asarray, plan)))
        for field, g, h, j in zip(got._fields, got, next(host), want):
            assert g.dtype == torch.from_numpy(h).dtype, field
            np.testing.assert_array_equal(g.numpy(), h, err_msg=field)
            np.testing.assert_array_equal(g.numpy(), np.asarray(j),
                                          err_msg=field)
        short += int((plan.len_crop < CFG.min_len_seq).sum())
    assert short  # some utterances are shorter than a crop
    # a [k, B] plan gathers the k batches at once
    two = [next(plans), next(plans)]
    both = collate_on_device(CFG, features, next(stack_plans(iter(two), 2)))
    for i, plan in enumerate(two):
        for g, w in zip(both, collate_on_device(CFG, features, plan)):
            assert torch.equal(g[i], w)


def test_bfloat16_store_equals_jax(tree):
    dataset, jdataset = tree
    f32, utts = build_resident(dataset, CFG, device="cpu")
    bf16, _ = build_resident(dataset, CFG, store_dtype=torch.bfloat16,
                             device="cpu")
    jbf16, _ = jax_resident.build_resident(jdataset, JCFG,
                                           store_dtype=jnp.bfloat16)
    assert bf16.mel.dtype == bf16.f0.dtype == torch.bfloat16
    for name in ("mel", "f0"):
        np.testing.assert_array_equal(
            getattr(bf16, name).float().numpy(),
            np.asarray(getattr(jbf16, name), np.float32), err_msg=name)
    plan = next(_plans(utts, f32, seed=0))
    a = collate_on_device(CFG, f32, plan)
    b = collate_on_device(CFG, bf16, plan)
    assert b.mel.dtype == b.f0.dtype == torch.float32
    assert float((a.mel - b.mel).abs().max()) < 4e-3
    # the unvoiced sentinel survives bfloat16 (quantization tests x <= 0)
    assert float(b.f0.min()) < -1e9
    assert torch.equal(b.f0 < -1e9, a.f0 < -1e9)


@pytest.mark.parametrize("model", ["speechsplit", "f0_converter"])
def test_resident_step_equals_the_host_step(one_torch_thread, tree, model):
    """2 host-batch steps against 2 resident steps from one state, then a
    ``[2, B]`` resident call against 2 more host steps: losses,
    parameters and the draws' generator bit for bit."""
    dataset, _ = tree
    make = make_train_step if model == "speechsplit" else make_f0_train_step
    features, utts = build_resident(dataset, F32, device="cpu")
    host_step = make(F32)
    res_step = make_resident_train_step(F32, features, model)
    a = create_train_state(F32, 0, model, device="cpu")
    b = create_train_state(F32, 0, model, device="cpu")
    host = data_loader(dataset, F32, seed=5)
    plans = plan_batches(utts, features.length.numpy(), F32, seed=5)
    for _ in range(2):
        a, want = host_step(a, next(host))
        b, got = res_step(b, next(plans))
        assert got.shape == () and torch.equal(got, want)
    b, losses = res_step(b, next(stack_plans(plans, 2)))
    a, l3 = host_step(a, next(host))
    a, l4 = host_step(a, next(host))
    assert torch.equal(losses, torch.stack([l3, l4]))
    assert a.step == b.step == 4
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name


def test_extract_into_store_refuses_a_row_out_of_range():
    mel = torch.zeros((2, 40, 80))
    f0 = torch.full((2, 40), UNVOICED)
    wavs = np.zeros((1, 1, 2048), np.int16)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        extract_into_store(mel, f0, wavs, np.array([[2048]]),
                           np.array([[50.0]]), np.array([[250.0]]),
                           np.array([[2]]), uniform=np.zeros((1, 1, 2048)))


def test_store_from_wavs_equals_extract_dir(tmp_path):
    """2 speakers x 5 wavs in all at B2 and 2 batches a group (a short
    group among them): the bfloat16 store from the wavs equals the
    archival flow's, bit for bit, for the same seed."""
    wav_dir = str(tmp_path / "wavs")
    make_corpus(wav_dir, 5, n_speakers=2, duration_s=0.6)
    speakers = sorted(os.listdir(wav_dir))
    spk2gen = {s: ("M" if i % 2 == 0 else "F")
               for i, s in enumerate(speakers)}
    _, entries = prepare._enumerate_entries(wav_dir, spk2gen)
    groups = [k for _, k in prepare._staged_groups(
        wav_dir, entries, batch_size=2, batches_per_dispatch=2)]
    assert sum(groups) == 3 and min(groups) == 1
    mel_dir, f0_dir = str(tmp_path / "spmel"), str(tmp_path / "raptf0")
    prepare.extract_dir(wav_dir, mel_dir, f0_dir, spk2gen, batch_size=2,
                        batches_per_dispatch=2, seed=5, compress_fetch=True,
                        device="cpu")
    meta = prepare.build_metadata(mel_dir)
    disk, disk_utts = build_resident(
        SpeakerDataset(mel_dir, f0_dir, metadata=meta), CFG,
        store_dtype=torch.bfloat16, device="cpu")
    direct, utts = build_resident_from_wavs(
        wav_dir, spk2gen, CFG, torch.bfloat16, batch_size=2,
        batches_per_dispatch=2, seed=5, device="cpu")
    assert utts == disk_utts == [[0, 1, 2], [3, 4]]
    for field, a, b in zip(direct._fields, direct, disk):
        assert a.dtype == b.dtype and torch.equal(a, b), field
    assert direct.mel.dtype == torch.bfloat16


def test_store_from_wavs_with_jax_draws_equals_jax(tmp_path):
    """tests/test_torch_prepare.py's wav tree (2 speakers x 3 wavs, B2,
    2 batches a group: a short group, then a full one), JAX's dither
    draws injected, float32 stores: the lengths, embeddings and order
    equal; mel within 1e-5; F0 as that file holds the two packages'
    files (each utterance's last frame may differ, and with it the
    speaker normalization's affine map)."""
    wav_dir = str(tmp_path / "wavs")
    _write_wavs(wav_dir)
    ours, utts = build_resident_from_wavs(
        wav_dir, SPK2GEN, CFG, seed=SEED, device="cpu",
        dither=jax_dither(SEED), **STAGING)
    theirs, jutts = jax_resident.build_resident_from_wavs(
        wav_dir, SPK2GEN, JCFG, seed=SEED, **STAGING)
    assert utts == jutts
    for name in ("length", "spk_emb"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    assert ours.mel.shape == theirs.mel.shape
    np.testing.assert_allclose(ours.mel.numpy(), np.asarray(theirs.mel),
                               rtol=0, atol=1e-5)
    tracks = _tracks(wav_dir)
    uid = {key: i for i, key in enumerate(sorted(tracks))}
    checked = 0
    for key, (n, own, jtrack) in tracks.items():
        f0 = ours.f0[uid[key]].numpy()
        want = np.asarray(theirs.f0[uid[key]])
        assert (f0[n:] == UNVOICED).all() and (want[n:] == UNVOICED).all()
        f0, want = f0[:n], want[:n]
        np.testing.assert_array_equal(f0, _normalized(own, n, own[n - 1]))
        np.testing.assert_allclose(f0, _normalized(jtrack, n, own[n - 1]),
                                   rtol=0, atol=1e-5)
        last = _last_frame_of(want, jtrack, n)
        np.testing.assert_allclose(want, _normalized(jtrack, n, last),
                                   rtol=0, atol=1e-5)
        if abs(own[n - 1] - last) <= 1e-5:
            np.testing.assert_allclose(f0, want, rtol=0, atol=1e-5)
            checked += 1
    assert checked == 2
