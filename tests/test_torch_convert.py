"""The port's conversion driver against the JAX package's, on synthetic
pairs at a tiny config (weights carried by interop), and its CLI."""

import pickle

import jax
import numpy as np
import pytest
import torch

from speechsplit_tpu import convert as jconvert
from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu_torch import convert as tconvert
from speechsplit_tpu_torch.cli import convert as cli_convert
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import (
    jax_params_to_state_dict,
    save_reference_checkpoint,
)
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

TINY = dict(
    dim_enc=64, dim_enc_2=32, dim_enc_3=64,
    dim_neck=4, dim_neck_2=1, dim_neck_3=8,
    dim_dec_mel=64, dim_dec_f0=32,
    max_len_pad=32, max_len_seq=32, min_len_seq=16,
)
HPARAMS = ",".join(f"{k}={v}" for k, v in TINY.items())
ATOL = 5e-5


def _raw(rng, length):
    mel = rng.rand(length, 80).astype(np.float32)
    f0 = np.where(rng.rand(length) < 0.2, 0.0, rng.rand(length))
    emb = np.zeros(82, np.float32)
    emb[rng.randint(0, 82)] = 1.0
    return mel, f0.astype(np.float32), emb


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JaxConfig(**TINY), SpeechSplitConfig(**TINY)
    t = cfg.max_len_pad
    rngs = {"params": jax.random.PRNGKey(3), "resample": jax.random.PRNGKey(4)}
    jg, jp = JaxSpeechSplit(jcfg), JaxF0Converter(jcfg)
    g_params = jg.init(rngs, np.zeros((1, t, 337), np.float32),
                       np.zeros((1, t, 80), np.float32),
                       np.zeros((1, 82), np.float32))["params"]
    p_params = jp.init(rngs, np.zeros((1, t, 80), np.float32),
                       np.zeros((1, t, 257), np.float32))["params"]
    g = SpeechSplit(cfg, torch.Generator()).eval()
    g.load_state_dict(jax_params_to_state_dict(g_params, "speechsplit"))
    p = F0Converter(cfg, torch.Generator()).eval()
    p.load_state_dict(jax_params_to_state_dict(p_params, "f0_converter"))
    return (jg, g_params, jp, p_params), (g, p)


def _pairs(lengths, seed=0):
    rng = np.random.RandomState(seed)
    jcfg, cfg = JaxConfig(**TINY), SpeechSplitConfig(**TINY)
    jax_pairs, port_pairs = [], []
    for p, (ls, lt) in enumerate(lengths):
        side = []
        for tag, length in (("s", ls), ("t", lt)):
            mel, f0, emb = _raw(rng, length)
            side.append((
                jconvert.prepare_utterance(jcfg, mel, f0, emb,
                                           name=f"{tag}{p}", uid=f"u{p}"),
                tconvert.prepare_utterance(cfg, mel, f0, emb,
                                           name=f"{tag}{p}", uid=f"u{p}",
                                           device="cpu"),
            ))
        jax_pairs.append((side[0][0], side[1][0]))
        port_pairs.append((side[0][1], side[1][1]))
    return jax_pairs, port_pairs


def _assert_results(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, err_msg=name)


def test_convert_batched_matches_jax(models):
    (jg, g_params, jp, p_params), (g, p) = models
    jax_pairs, port_pairs = _pairs([(30, 25), (20, 32)])
    want = jconvert.convert_batched(jg, g_params, jp, p_params, jax_pairs)
    got = tconvert.convert_batched(g, p, port_pairs)
    assert len(got) == 2
    for got_pair, want_pair in zip(got, want):
        assert [n.rsplit("_", 1)[1] for n, _ in got_pair] == list(
            tconvert.CONDITIONS)
        _assert_results(got_pair, want_pair)
    # the per-utterance driver gives the same conversions
    for pi, (src, trg) in enumerate(port_pairs):
        _assert_results(tconvert.convert(g, p, src, trg), want[pi])


def test_convert_f0_is_onehot(models):
    _, (g, p) = models
    _, ((src, trg),) = _pairs([(28, 24)], seed=1)
    onehot = tconvert.convert_f0(p, src, trg)
    assert onehot.shape == (1, 32, 257)
    np.testing.assert_array_equal(onehot.sum(-1).numpy(), 1.0)


def test_prepare_utterance_matches_jax():
    rng = np.random.RandomState(2)
    mel, f0, emb = _raw(rng, 27)
    f0[3] = -1e10  # an unvoiced sentinel
    want = jconvert.prepare_utterance(JaxConfig(**TINY), mel, f0, emb,
                                      name="a", uid="b")
    got = tconvert.prepare_utterance(SpeechSplitConfig(**TINY), mel, f0, emb,
                                     name="a", uid="b", device="cpu")
    assert (got.length, got.name, got.uid) == (want.length, "a", "b")
    for field in ("mel", "f0_onehot", "spk_emb"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


def test_cli_writes_seven_mels(models, tmp_path, capsys):
    _, (g, p) = models
    save_reference_checkpoint(g, str(tmp_path / "G.ckpt"))
    save_reference_checkpoint(p, str(tmp_path / "P.ckpt"))
    rng = np.random.RandomState(3)
    entries = []
    for i, length in enumerate((30, 22)):
        mel, f0, emb = _raw(rng, length)
        entries.append([f"p{i}", emb[None], (mel, f0, length, f"00{i}")])
    with open(tmp_path / "demo.pkl", "wb") as handle:
        pickle.dump(entries, handle)
    out_dir = tmp_path / "out"
    cli_convert.main([
        "--generator_ckpt", str(tmp_path / "G.ckpt"),
        "--f0_ckpt", str(tmp_path / "P.ckpt"),
        "--metadata", str(tmp_path / "demo.pkl"),
        "--out_dir", str(out_dir), "--device", "cpu",
        "--hparams", HPARAMS,
    ])
    names = {f"p0_p1_000_{c}.npy" for c in tconvert.CONDITIONS}
    assert {f.name for f in out_dir.iterdir()} == names
    rfu = np.load(out_dir / "p0_p1_000_RFU.npy")
    assert rfu.shape == (22, 80) and np.isfinite(rfu).all()
    assert np.load(out_dir / "p0_p1_000_F.npy").shape == (30, 80)
    assert "RFU" in capsys.readouterr().out


def test_cli_rejects_orbax_directories(tmp_path):
    with pytest.raises(SystemExit):
        cli_convert.main(["--generator_ckpt", str(tmp_path),
                          "--f0_ckpt", str(tmp_path), "--device", "cpu"])
