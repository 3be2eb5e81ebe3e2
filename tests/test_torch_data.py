"""The port's data pipeline against the JAX package's, on one feature
tree written with numpy: the sampler's epochs, the dataset's entries
(eager and lazy, train and test split), the loader's batches bit for
bit, and the prefetcher (order, values, bfloat16 feed, errors)."""

import dataclasses
import os
import pickle
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from speechsplit_tpu.data import dataset as jax_dataset
from speechsplit_tpu.data import loader as jax_loader
from speechsplit_tpu.data import sampler as jax_sampler
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.data import (
    Batch,
    RepeatSampler,
    SpeakerDataset,
    data_loader,
    load_metadata,
    prefetch_to_device,
)
from speechsplit_tpu_torch.training.train_step import _upcast_batch
from tests.test_pallas_multilstm import _tiny_config

JCFG = _tiny_config()
CFG = SpeechSplitConfig(**dataclasses.asdict(JCFG))


def write_feature_tree(root, n_speakers, utts_per_speaker, seed,
                       frames=(20, 60), dim_freq=80, dim_spk_emb=82):
    """A seeded feature tree as the preprocessing CLIs write it:
    ``spmel/<spk>/<utt>.npy`` mels ([T, 80], a few values outside [0, 1]
    for the collator's clip), ``raptf0/<spk>/<utt>.npy`` normalized F0
    with unvoiced zeros, and ``spmel/train.pkl`` ([speaker, one-hot
    embedding, rel paths...]). ``utts_per_speaker`` is an int or a
    per-speaker sequence. Returns (root_dir, feat_dir)."""
    rng = np.random.default_rng(seed)
    root_dir, feat_dir = os.path.join(root, "spmel"), os.path.join(root,
                                                                   "raptf0")
    counts = (utts_per_speaker if not isinstance(utts_per_speaker, int)
              else [utts_per_speaker] * n_speakers)
    meta = []
    for s, count in enumerate(counts):
        spk = f"p{s:03d}"
        os.makedirs(os.path.join(root_dir, spk), exist_ok=True)
        os.makedirs(os.path.join(feat_dir, spk), exist_ok=True)
        emb = np.zeros(dim_spk_emb, np.float32)
        emb[s % dim_spk_emb] = 1.0
        entry = [spk, emb]
        for u in range(count):
            t = int(rng.integers(*frames))
            mel = rng.uniform(-0.05, 1.05, (t, dim_freq)).astype(np.float32)
            f0 = np.where(rng.random(t) < 0.25, 0.0,
                          rng.random(t)).astype(np.float32)
            rel = f"{spk}/{spk}_{u:03d}.npy"
            np.save(os.path.join(root_dir, rel), mel)
            np.save(os.path.join(feat_dir, rel), f0)
            entry.append(rel)
        meta.append(entry)
    with open(os.path.join(root_dir, "train.pkl"), "wb") as handle:
        pickle.dump(meta, handle)
    return root_dir, feat_dir


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_feature_tree(str(tmp_path_factory.mktemp("feats")), 5,
                              [1, 3, 2, 1, 3], seed=4)


@pytest.mark.parametrize("shuffle", [True, False])
def test_sampler_epochs_match_jax(shuffle):
    ours = RepeatSampler(7, 3, shuffle=shuffle)
    theirs = jax_sampler.RepeatSampler(7, 3, shuffle=shuffle)
    assert len(ours) == len(theirs) == 21
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(4):
        np.testing.assert_array_equal(ours.epoch(rng_a), theirs.epoch(rng_b))


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "lazy"])
@pytest.mark.parametrize("mode,split", [("train", 0), ("train", 10),
                                        ("test", 10)])
def test_dataset_entries_match_jax(tree, eager, mode, split):
    root_dir, feat_dir = tree
    ours = SpeakerDataset(root_dir, feat_dir, mode=mode, split=split,
                          eager=eager)
    theirs = jax_dataset.SpeakerDataset(root_dir, feat_dir, mode=mode,
                                        split=split, eager=eager)
    assert len(ours) == len(theirs) == 5
    assert ours.speakers() == theirs.speakers()
    for (spk, emb, utts), (jspk, jemb, jutts) in zip(ours.entries,
                                                     theirs.entries):
        assert spk == jspk
        np.testing.assert_array_equal(emb, jemb)
        assert emb.dtype == np.float32
        assert len(utts) == len(jutts)
        for (mel, f0), (jmel, jf0) in zip(utts, jutts):
            assert len(mel) == len(jmel) == len(f0)
            np.testing.assert_array_equal(np.asarray(mel), np.asarray(jmel))
            np.testing.assert_array_equal(np.asarray(f0), np.asarray(jf0))
            np.testing.assert_array_equal(mel[2:7], jmel[2:7])
    if mode == "test":
        assert all(len(u[0]) == split for e in ours.entries for u in e[2])
    # get() draws from the shared rng exactly as JAX's does
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    for index in [1, 0, 4, 1, 2, 4]:
        mel, emb, f0 = ours.get(index, rng_a)
        jmel, jemb, jf0 = theirs.get(index, rng_b)
        np.testing.assert_array_equal(np.asarray(mel), np.asarray(jmel))
        np.testing.assert_array_equal(np.asarray(f0), np.asarray(jf0))
    assert rng_a.integers(1 << 30) == rng_b.integers(1 << 30)


def test_metadata_round_trip(tree):
    meta = load_metadata(tree[0])
    theirs = jax_dataset.load_metadata(tree[0])
    assert [m[0] for m in meta] == [m[0] for m in theirs]
    assert [m[2:] for m in meta] == [m[2:] for m in theirs]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("utts", [1, 3])
def test_loader_batches_bit_identical_to_jax(tmp_path, seed, utts):
    root_dir, feat_dir = write_feature_tree(str(tmp_path), 5, utts,
                                            seed=10 + utts)
    ours = data_loader(SpeakerDataset(root_dir, feat_dir), CFG, seed=seed)
    theirs = jax_loader.data_loader(
        jax_dataset.SpeakerDataset(root_dir, feat_dir), JCFG, seed=seed)
    # 5 speakers x 8 repeats = 40 a epoch, 2 batches of 16: 3 epochs
    for _ in range(6):
        got, want = next(ours), next(theirs)
        assert isinstance(got, Batch)
        for name, a, b in zip(Batch._fields, got, want):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.mel.shape == (CFG.batch_size, CFG.max_len_pad,
                                 CFG.dim_freq)


def _batches(n, seed=0, fail_after=None):
    rng = np.random.RandomState(seed)
    for i in range(n):
        if fail_after is not None and i == fail_after:
            raise ValueError(f"source failed at batch {i}")
        yield Batch(
            mel=rng.rand(4, 32, 80).astype(np.float32),
            spk_emb=np.eye(4, 82, dtype=np.float32),
            f0=np.where(rng.rand(4, 32, 1) < 0.2, -1e10,
                        rng.rand(4, 32, 1)).astype(np.float32),
            len_org=rng.randint(16, 33, 4).astype(np.int32),
        )


def test_prefetch_keeps_order_and_values():
    src = list(_batches(5))
    out = list(prefetch_to_device(iter(src), device="cpu"))
    assert len(out) == 5
    for a, b in zip(src, out):
        for x, y in zip(a, b):
            assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
            assert y.dtype == torch.from_numpy(x).dtype
            np.testing.assert_array_equal(y.numpy(), x)


def test_compressed_prefetch_restores_within_bf16_rounding():
    src = list(_batches(2, seed=3))
    out = list(prefetch_to_device(iter(src), device="cpu", compress=True))
    for a, b in zip(src, out):
        assert b.mel.dtype == b.spk_emb.dtype == b.f0.dtype == torch.bfloat16
        assert b.len_org.dtype == torch.int32  # ints untouched
        up = _upcast_batch(b, "cpu")
        for name in ("mel", "spk_emb", "f0"):
            x, y = getattr(a, name), getattr(up, name).numpy()
            assert y.dtype == np.float32
            # round to nearest: within half a bf16 ulp (8 mantissa bits)
            np.testing.assert_array_less(np.abs(y - x),
                                         np.abs(x) * 2.0 ** -8 + 1e-30)
            np.testing.assert_array_equal(
                y, torch.from_numpy(x).bfloat16().float().numpy())
            # the JAX package's feed rounds the same way (ml_dtypes)
            np.testing.assert_array_equal(
                y, x.astype(ml_dtypes.bfloat16).astype(np.float32))
        np.testing.assert_array_equal(up.len_org.numpy(), a.len_org)


def test_prefetch_reraises_the_source_error():
    out = prefetch_to_device(_batches(5, fail_after=2), device="cpu")
    next(out), next(out)
    with pytest.raises(ValueError, match="source failed at batch 2"):
        next(out)
    with pytest.raises(StopIteration):
        next(out)


def test_prefetch_close_stops_the_thread():
    pulled = []

    def source():
        for batch in _batches(1000):
            pulled.append(1)
            yield batch

    out = prefetch_to_device(source(), size=2, device="cpu")
    next(out)
    out.close()
    count = len(pulled)
    assert count <= 5  # one handed over, at most size queued, one in hand
    time.sleep(0.2)
    assert len(pulled) == count


def test_prefetch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefetch_to_device(_batches(1))
