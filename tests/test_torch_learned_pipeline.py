"""Zero-shot conversion in the port (``spk_emb_mode="learned"``) against
the JAX package's: ``with_learned_embedding`` and ``convert_batched``,
``VoiceConverter`` on wav files with no embeddings passed, and the two
CLIs with the shipped neural vocoder (``--vocoder_ckpt default``, 48
refinement iterations), on the CPU. The weights are JAX params carried
by ``interop.jax_params_to_state_dict`` (a learned ``.ckpt`` for the
port's CLIs; the JAX CLI is handed the same params).

Bars: the embeddings within 2e-5, the mels within 5e-5 (PARITY.md's
conversion bar). The wavs: ``cli.convert`` with ``--vocoder_refine 0``
writes JAX's within tests/test_torch_vocoder_neural.py's
``PCM16_LSB``. With 48 iterations (``cli.serve``'s default) the wavs are
held to the port's own vocoder on the mels written, bit for bit: on
the mels of these untrained generators (near-silent, some below 0) the
refinement amplifies float32 rounding, measured 0.7-3.1% of the peak
after 48 iterations against 1.4e-5 after none, with JAX's own mels in
both packages. test_torch_vocoder_neural.py holds the 48 iterations to
JAX on speech mels.
From wav files, every condition on JAX's own features; end to end the
conditions that take the source's F0 (R, U, RU): the short pair's
target has one frame whose F0 bin differs from JAX's
(tests/test_torch_pipeline.py ``BINS_OFF``, ROADMAP.md C).
"""

import json
import pickle
import threading
import urllib.request
from http.server import HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speechsplit_tpu import convert as jconvert
from speechsplit_tpu.cli import convert as jax_cli_convert
from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.pipeline import VoiceConverter as JaxVoiceConverter
from speechsplit_tpu.vocoder_neural import load_vocoder as jax_load_vocoder
from speechsplit_tpu_torch import convert as tconvert
from speechsplit_tpu_torch import pipeline
from speechsplit_tpu_torch.cli import convert as cli_convert
from speechsplit_tpu_torch.cli import serve
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import (
    jax_params_to_state_dict,
    save_reference_checkpoint,
)
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.pipeline import VoiceConverter
from speechsplit_tpu_torch.vocoder_neural import load_vocoder
from tests.test_torch_pipeline import SMALL, _jax_draws
from tests.test_torch_speaker_encoder import jax_learned_params
from tests.test_torch_vocoder_neural import PCM16_LSB
from tests.speech_stimuli import default_utterance

LEARNED = dict(SMALL, spk_emb_mode="learned", dim_spk_enc=32)
HPARAMS = ",".join(f"{k}={v}" for k, v in LEARNED.items())
FS = 16000
EMB_ATOL = 2e-5
ATOL = 5e-5
SOURCE_F0 = ("R", "U", "RU")
CONDITIONS = ("R", "F", "U", "RF", "RU", "FU", "RFU")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("learned")
    jcfg, cfg = JaxConfig(**LEARNED), SpeechSplitConfig(**LEARNED)
    g_params = jax_learned_params(jcfg)
    t = jcfg.max_len_pad
    rngs = {"params": jax.random.PRNGKey(1), "resample": jax.random.PRNGKey(2)}
    p_params = jax.jit(JaxF0Converter(jcfg).init)(
        rngs, jnp.zeros((1, t, 80)), jnp.zeros((1, t, 257)))["params"]
    paths = {}
    for (name, params, cls), tag in zip(
            (("speechsplit", g_params, SpeechSplit),
             ("f0_converter", p_params, F0Converter)), ("G", "P")):
        model = cls(cfg, torch.Generator())
        model.load_state_dict(jax_params_to_state_dict(params, name),
                              strict=True)
        paths[tag] = str(root / f"{tag}.ckpt")
        save_reference_checkpoint(model, paths[tag])
    # tests/test_torch_pipeline.py's short pair
    for side, wav in (("src", default_utterance(3, 120.0).wav[:32000]),
                      ("trg", default_utterance(5, 220.0).wav[:28000])):
        paths[side] = str(root / f"{side}.wav")
        wavfile.write(paths[side], FS,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return root, jcfg, cfg, g_params, p_params, paths


def _port_models(cfg, g_params, p_params):
    g = SpeechSplit(cfg, torch.Generator())
    g.load_state_dict(jax_params_to_state_dict(g_params, "speechsplit"))
    p = F0Converter(cfg, torch.Generator())
    p.load_state_dict(jax_params_to_state_dict(p_params, "f0_converter"))
    return g.eval(), p.eval()


def test_with_learned_embedding_and_convert_batched_match_jax(setup):
    _, jcfg, cfg, g_params, p_params, _ = setup
    g, p = _port_models(cfg, g_params, p_params)
    rng = np.random.RandomState(0)
    raw = []
    for length in (150, 121, 188, 97):
        mel = rng.rand(length, 80).astype(np.float32)
        f0 = np.where(rng.rand(length) < 0.2, 0.0, rng.rand(length))
        raw.append((mel, f0.astype(np.float32),
                    np.eye(82, dtype=np.float32)[rng.randint(82)]))
    jg = JaxSpeechSplit(jcfg)
    j_utts = [jconvert.with_learned_embedding(
        jcfg, jg, g_params, jconvert.prepare_utterance(jcfg, *r))
        for r in raw]
    t_utts = [tconvert.with_learned_embedding(
        cfg, g, tconvert.prepare_utterance(cfg, *r, device="cpu"))
        for r in raw]
    for ju, tu in zip(j_utts, t_utts):
        assert tu.spk_emb.shape == (1, 82)
        np.testing.assert_allclose(tu.spk_emb.numpy(), np.asarray(ju.spk_emb),
                                   rtol=0, atol=EMB_ATOL)
    want = jconvert.convert_batched(
        jg, g_params, JaxF0Converter(jcfg), p_params,
        [(j_utts[0], j_utts[1]), (j_utts[2], j_utts[3])])
    got = tconvert.convert_batched(g, p, [(t_utts[0], t_utts[1]),
                                          (t_utts[2], t_utts[3])])
    for pair_got, pair_want in zip(got, want):
        for (n_g, m_g), (n_w, m_w) in zip(pair_got, pair_want):
            assert n_g == n_w and m_g.shape == m_w.shape
            np.testing.assert_allclose(m_g, m_w, rtol=0, atol=ATOL)
    # one-hot mode: a no-op
    onehot = cfg.replace(spk_emb_mode="onehot")
    assert tconvert.with_learned_embedding(onehot, g, t_utts[0]) is t_utts[0]


@pytest.fixture(scope="module")
def jax_request(setup):
    """JAX's zero-shot request on the short pair, as its cli.serve handler
    makes it (neural vocoder, 48 iterations, PCM16), and its features."""
    _, jcfg, _, g_params, p_params, paths = setup
    ref = JaxVoiceConverter(jcfg, g_params, p_params,
                            vocoder=jax_load_vocoder("default",
                                                     refine_iters=48))
    features = {gender: ref.extract_features_full(
        pipeline.read_wav(paths[side]), gender)
        for side, gender in (("src", "M"), ("trg", "F"))}
    want = ref.convert_wav_files(paths["src"], paths["trg"], pcm16=True)
    mel = features["M"][0]
    emb = ref.speaker_embedding_from_mel(np.concatenate([mel, mel]))
    return want, features, emb


def test_convert_wav_files_learned_equals_jax(setup, jax_request,
                                              monkeypatch):
    _, _, cfg, g_params, p_params, paths = setup
    want, features, jax_emb = jax_request
    g, p = _port_models(cfg, g_params, p_params)
    port = VoiceConverter(cfg, g, p, device="cpu", dither_draws=_jax_draws)
    mel_src = port.extract_features_full(pipeline.read_wav(paths["src"]),
                                         "M")[0]
    # past max_len_pad frames the embedding takes the first max_len_pad
    twice = np.concatenate([mel_src, mel_src])
    assert len(twice) > cfg.max_len_pad
    np.testing.assert_allclose(port.speaker_embedding_from_mel(twice),
                               jax_emb, rtol=0, atol=EMB_ATOL)
    utt = port.extract_utterance(pipeline.read_wav(paths["src"]))
    np.testing.assert_array_equal(utt.spk_emb.numpy(),
                                  port.speaker_embedding_from_mel(mel_src))
    end_to_end = port.convert_wav_files(paths["src"], paths["trg"],
                                        synthesize=False)
    with monkeypatch.context() as patch:
        patch.setattr(port, "extract_features_full",
                      lambda wav, gender: features[gender])
        on_jax_features = port.convert_wav_files(paths["src"], paths["trg"],
                                                 synthesize=False)
    for got, which in ((on_jax_features, CONDITIONS),
                       (end_to_end, SOURCE_F0)):
        assert set(got) == set(want) == set(CONDITIONS)
        for condition in which:
            np.testing.assert_allclose(got[condition]["mel"],
                                       want[condition]["mel"], rtol=0,
                                       atol=ATOL)


def test_long_pair_embeds_each_files_full_mel(setup, monkeypatch):
    """Past ``max_len_pad`` frames (a 32-frame model here) each file's
    embedding is its full mel's (its first ``max_len_pad`` frames), for
    every ``convert_long`` window."""
    _, _, cfg, g_params, p_params, paths = setup
    small = cfg.replace(max_len_pad=32, max_len_seq=32, min_len_seq=16)
    g, p = _port_models(small, g_params, p_params)
    port = VoiceConverter(small, g, p, device="cpu")
    seen = []

    def spy(config, g_model, p_model, s_mel, s_f0, s_emb, t_mel, t_f0,
            t_emb, condition):
        seen.append((s_mel, s_emb, t_mel, t_emb))
        return convert_long(config, g_model, p_model, s_mel, s_f0, s_emb,
                            t_mel, t_f0, t_emb, condition=condition)

    convert_long = pipeline.convert_long
    monkeypatch.setattr(pipeline, "convert_long", spy)
    out = port.convert_wav_files(paths["src"], paths["trg"],
                                 conditions=("RU",), synthesize=False)
    ((s_mel, s_emb, t_mel, t_emb),) = seen
    assert len(s_mel) > 32 and out["RU"]["mel"].shape == (len(t_mel), 80)
    np.testing.assert_array_equal(s_emb, port.speaker_embedding_from_mel(s_mel))
    np.testing.assert_array_equal(t_emb, port.speaker_embedding_from_mel(t_mel))
    assert not np.array_equal(s_emb, t_emb)


def test_serve_with_the_neural_vocoder_writes_what_jax_writes(
        setup, jax_request, monkeypatch):
    """``cli.serve.main`` with ``--vocoder_ckpt default`` (its HTTP server
    caught before it serves), then a request through its handler, the
    extractions on JAX's dither draws."""
    root, _, cfg, _, _, paths = setup
    want, _, _ = jax_request
    built = {}

    class Caught:
        def __init__(self, address, handler):
            built["handler"] = handler

        server_port = 0

        def serve_forever(self):
            pass

    monkeypatch.setattr(serve, "HTTPServer", Caught)
    # JAX's dither draws (JAX PRNG streams cannot be reproduced in torch)
    monkeypatch.setattr(VoiceConverter, "_draws",
                        lambda self, shape: _jax_draws(shape))
    serve.main(["--generator_ckpt", paths["G"], "--f0_ckpt", paths["P"],
                "--vocoder_ckpt", "default", "--device", "cpu",
                "--hparams", HPARAMS])
    httpd = HTTPServer(("127.0.0.1", 0), built["handler"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_port}/convert",
            data=json.dumps({"source_wav": paths["src"],
                             "target_wav": paths["trg"],
                             "out_dir": str(root / "served")}).encode())
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = json.loads(resp.read())
    finally:
        httpd.shutdown()
        thread.join()
    assert set(body["results"]) == set(CONDITIONS)
    mels, wavs = [], []
    for condition in CONDITIONS:
        info = body["results"][condition]
        mels.append(np.load(info["mel_path"]))
        rate, wav = wavfile.read(info["wav_path"])
        assert rate == FS and wav.shape == want[condition]["wav"].shape
        wavs.append(wav)
    for condition in SOURCE_F0:
        np.testing.assert_allclose(mels[CONDITIONS.index(condition)],
                                   want[condition]["mel"], rtol=0, atol=ATOL)
    vocoder = load_vocoder("default", refine_iters=48, device="cpu")
    for got, ref in zip(vocoder.synthesize_batch(mels, pcm16=True), wavs):
        assert got.dtype == ref.dtype == np.int16
        np.testing.assert_array_equal(got, ref)


def test_convert_cli_with_the_neural_vocoder_writes_what_jax_writes(
        setup, tmp_path, monkeypatch):
    _, _, _, g_params, p_params, paths = setup
    rng = np.random.RandomState(3)
    entries = []
    for i, length in enumerate((140, 117)):
        emb = np.zeros((1, 82), np.float32)
        emb[0, 3 + i] = 1.0
        mel = rng.rand(length, 80).astype(np.float32)
        f0 = np.where(rng.rand(length) < 0.2, 0.0, rng.rand(length))
        entries.append([f"p{i}", emb, (mel, f0.astype(np.float32), length,
                                       f"00{i}")])
    demo = str(tmp_path / "demo.pkl")
    with open(demo, "wb") as handle:
        pickle.dump(entries, handle)
    common = ["--metadata", demo, "--synthesize", "--vocoder_ckpt",
              "default", "--vocoder_refine", "0", "--hparams", HPARAMS,
              "--conditions", "R,U,RFU"]
    monkeypatch.setattr(jax_cli_convert, "_load_params",
                        lambda path, model, config: {
                            "G": g_params, "P": p_params}[path])
    jax_cli_convert.main(["--generator_ckpt", "G", "--f0_ckpt", "P",
                          "--out_dir", str(tmp_path / "jax"), *common])
    cli_convert.main(["--generator_ckpt", paths["G"], "--f0_ckpt",
                      paths["P"], "--out_dir", str(tmp_path / "port"),
                      "--device", "cpu", *common])
    for condition in ("R", "U", "RFU"):
        stem = f"p0_p1_000_{condition}"
        np.testing.assert_allclose(np.load(tmp_path / "port" / f"{stem}.npy"),
                                   np.load(tmp_path / "jax" / f"{stem}.npy"),
                                   rtol=0, atol=ATOL)
        _, got = wavfile.read(tmp_path / "port" / f"{stem}.wav")
        _, ref = wavfile.read(tmp_path / "jax" / f"{stem}.wav")
        assert got.dtype == ref.dtype == np.int16 and got.shape == ref.shape
        assert int(np.abs(got.astype(np.int32) - ref).max()) <= PCM16_LSB
