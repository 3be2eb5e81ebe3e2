"""The port's conversion server (``cli/serve.py``), mirroring the JAX
package's tests/test_serve.py: health, the happy path (7 PCM16 wavs and
7 mels), malformed requests and an unknown endpoint, on the CPU with
weights carried from JAX params; and the CLIs' refused and new flags
(a vocoder checkpoint the port cannot read)."""

import json
import os
import pickle
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu.training.train_step import create_train_state
from speechsplit_tpu_torch.cli import convert as cli_convert
from speechsplit_tpu_torch.cli import serve
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import (
    jax_params_to_state_dict,
    save_reference_checkpoint,
)
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.pipeline import VoiceConverter

SMALL = dict(
    dim_enc=64, dim_enc_2=32, dim_enc_3=64,
    dim_neck=4, dim_neck_2=1, dim_neck_3=8,
    dim_dec_mel=64, dim_dec_f0=32,
)
HPARAMS = ",".join(f"{k}={v}" for k, v in SMALL.items())
FS = 16000
CONDITIONS = {"R", "F", "U", "RF", "RU", "FU", "RFU"}


def _tone(f0, n, seed=0):
    t = np.arange(n) / FS
    r = np.random.RandomState(seed)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 4))
    sig = sig + 0.01 * r.randn(n)
    return (sig / np.abs(sig).max() * 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = JaxConfig(**SMALL), SpeechSplitConfig(**SMALL)
    _, g_state = create_train_state(jcfg, jax.random.PRNGKey(0))
    _, p_state = create_train_state(jcfg, jax.random.PRNGKey(1),
                                    "f0_converter")
    g = SpeechSplit(cfg, torch.Generator())
    g.load_state_dict(jax_params_to_state_dict(g_state.params, "speechsplit"))
    p = F0Converter(cfg, torch.Generator())
    p.load_state_dict(jax_params_to_state_dict(p_state.params,
                                               "f0_converter"))
    return cfg, g, p


@pytest.fixture(scope="module")
def server(tmp_path_factory, models):
    root = tmp_path_factory.mktemp("serve")
    for name, f0 in [("src", 120.0), ("trg", 210.0)]:
        wavfile.write(root / f"{name}.wav", FS,
                      (_tone(f0, FS) * 32767).astype(np.int16))
    cfg, g, p = models
    converter = VoiceConverter(cfg, g, p, device="cpu")
    httpd = HTTPServer(("127.0.0.1", 0),
                       serve.build_handler(converter, str(root / "out")))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_port}", root
    httpd.shutdown()
    thread.join()


def _post(url, payload):
    req = urllib.request.Request(
        url + "/convert", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def test_health(server):
    url, _ = server
    with urllib.request.urlopen(url + "/health", timeout=30) as resp:
        body = json.loads(resp.read())
    assert resp.status == 200
    assert body == {"status": "ok", "device": "cpu"}


def test_convert_happy_path(server):
    url, root = server
    status, body = _post(url, {"source_wav": str(root / "src.wav"),
                               "target_wav": str(root / "trg.wav")})
    assert status == 200
    assert set(body["results"]) == CONDITIONS
    frames = FS // 256 + 1
    for condition, info in body["results"].items():
        assert info["mel_shape"] == [frames, 80]
        mel = np.load(info["mel_path"])
        assert mel.shape == (frames, 80) and np.isfinite(mel).all()
        rate, wav = wavfile.read(info["wav_path"])
        assert rate == FS and wav.dtype == np.int16
        assert len(wav) == (frames - 1) * 256 and wav.any()
    written = os.listdir(root / "out")
    assert sum(f.endswith(".wav") for f in written) == 7
    assert sum(f.endswith(".npy") for f in written) == 7


def test_convert_missing_field(server):
    url, root = server
    req = urllib.request.Request(
        url + "/convert",
        data=json.dumps({"source_wav": str(root / "src.wav")}).encode())
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400
    assert "target_wav" in json.loads(err.value.read())["error"]


def test_convert_missing_file(server):
    url, _ = server
    req = urllib.request.Request(
        url + "/convert",
        data=json.dumps({"source_wav": "/nonexistent.wav",
                         "target_wav": "/nonexistent2.wav"}).encode())
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400


def test_unknown_endpoint(server):
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + "/bogus", timeout=30)
    assert err.value.code == 404


# a vocoder checkpoint the port cannot read: an Orbax directory (the JAX
# trainer's format, ROADMAP.md A7) and a missing file. The shipped
# ``default`` runs (tests/test_torch_learned_pipeline.py).
VOCODER_REFUSALS = [("DIR", NotImplementedError, "ROADMAP.md A7"),
                    ("nope.npz", FileNotFoundError, "nope.npz")]


def _vocoder_flag(tmp_path, name):
    return ["--vocoder_ckpt",
            str(tmp_path) if name == "DIR" else str(tmp_path / name)]


@pytest.mark.parametrize("flag", VOCODER_REFUSALS)
def test_serve_refuses_the_neural_vocoder(tmp_path, flag):
    name, error, match = flag
    with pytest.raises(error, match=match):
        serve.main(["--generator_ckpt", str(tmp_path / "G.ckpt"),
                    "--f0_ckpt", str(tmp_path / "P.ckpt"),
                    "--device", "cpu", *_vocoder_flag(tmp_path, name)])


@pytest.mark.parametrize("flag", VOCODER_REFUSALS)
def test_convert_cli_refuses_the_neural_vocoder(tmp_path, flag):
    name, error, match = flag
    with pytest.raises(error, match=match):
        cli_convert.main(["--generator_ckpt", str(tmp_path / "G.ckpt"),
                          "--f0_ckpt", str(tmp_path / "P.ckpt"),
                          "--device", "cpu", "--synthesize",
                          *_vocoder_flag(tmp_path, name)])


def test_convert_cli_synthesizes_pcm16(models, tmp_path):
    _, g, p = models
    save_reference_checkpoint(g, str(tmp_path / "G.ckpt"))
    save_reference_checkpoint(p, str(tmp_path / "P.ckpt"))
    rng = np.random.RandomState(3)
    entries = []
    for i, length in enumerate((40, 33)):
        emb = np.zeros((1, 82), np.float32)
        emb[0, 3 + i] = 1.0
        mel = rng.rand(length, 80).astype(np.float32)
        f0 = np.where(rng.rand(length) < 0.2, 0.0, rng.rand(length))
        entries.append([f"p{i}", emb, (mel, f0.astype(np.float32), length,
                                       f"00{i}")])
    with open(tmp_path / "demo.pkl", "wb") as handle:
        pickle.dump(entries, handle)
    out_dir = tmp_path / "out"
    cli_convert.main([
        "--generator_ckpt", str(tmp_path / "G.ckpt"),
        "--f0_ckpt", str(tmp_path / "P.ckpt"),
        "--metadata", str(tmp_path / "demo.pkl"), "--out_dir", str(out_dir),
        "--device", "cpu", "--hparams", HPARAMS, "--synthesize",
        "--compress_results", "--conditions", "R,RFU",
    ])
    for condition, frames in (("R", 33), ("RFU", 33)):
        mel = np.load(out_dir / f"p0_p1_000_{condition}.npy")
        assert mel.shape == (frames, 80)
        # fetched as bfloat16: every value a bfloat16
        np.testing.assert_array_equal(
            mel, torch.from_numpy(mel).to(torch.bfloat16).float().numpy())
        rate, wav = wavfile.read(out_dir / f"p0_p1_000_{condition}.wav")
        assert rate == FS and wav.dtype == np.int16
        assert len(wav) == (frames - 1) * 256
