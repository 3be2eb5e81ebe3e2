"""The port's wav-to-wav path as a whole (``pipeline.VoiceConverter``)
against the JAX package's: the same weights (JAX params through
``interop.jax_params_to_state_dict`` into ``.ckpt`` files), the same wav
files and JAX's dither draws injected. A short pair (within
``max_len_pad`` frames) takes ``convert_batched``, a long one
``convert_long``; the F0 tracks must agree frame for frame before the
seven mels are held to PARITY.md's conversion bar (5e-5); see
``test_convert_wav_files_equals_jax`` for the frames where they cannot."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speechsplit_tpu import linkprobe as jlinkprobe
from speechsplit_tpu import preprocess as jpre
from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu.ops import pitch as jpitch
from speechsplit_tpu.ops.quantize import quantize_f0 as jax_quantize_f0
from speechsplit_tpu.pipeline import VoiceConverter as JaxVoiceConverter
from speechsplit_tpu.training.train_step import create_train_state
from speechsplit_tpu_torch import linkprobe
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.convert import CONDITIONS
from speechsplit_tpu_torch.data.prepare import read_wav
from speechsplit_tpu_torch.interop import jax_params_to_state_dict
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.ops import pitch
from speechsplit_tpu_torch.pipeline import VoiceConverter
from speechsplit_tpu_torch.preprocess import GENDER_F0_RANGE
from tests.speech_stimuli import default_utterance, synth_utterance

SMALL = dict(
    dim_enc=64, dim_enc_2=32, dim_enc_3=64,
    dim_neck=4, dim_neck_2=1, dim_neck_3=8,
    dim_dec_mel=64, dim_dec_f0=32,
)
FS = 16000
ATOL = 5e-5
# frames a side (M source, F target) whose quantized F0 bin differs from
# JAX's: the short pair's target, through its last frame's log-F0 and the
# speaker normalization (ROADMAP.md C, limits)
BINS_OFF = {"short": {"M": 0, "F": 1}, "long": {"M": 0, "F": 0}}
# link profiles (f32 MB/s, bf16 MB/s, RTT ms): a tunnel-class link and a
# card in the host (JAX's tests/test_convert_batched.py)
TUNNEL = (29.0, 21.0, 10.0)
FAST = (4000.0, 3000.0, 0.1)


def _long(seed, f0):
    """A 3.3 s speech-like utterance (207 frames, past max_len_pad)."""
    return synth_utterance(seed, [
        ("voiced", 1.0, lambda r: f0 * (1.2 - 0.3 * r)),
        ("fricative", 0.3, None),
        ("voiced", 1.2, lambda r: f0 * (0.9 + 0.3 * np.sin(np.pi * r))),
        ("silence", 0.2, None),
        ("voiced", 0.6, lambda r: f0 * (1.1 - 0.2 * r)),
    ]).wav


def _jax_draws(shape):
    """JAX's dither draws: VoiceConverter's fixed key (seed 0) over the
    padded batch (pipeline.py:113-125)."""
    return torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(0), shape)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    wavs = {
        "short": (default_utterance(3, 120.0).wav[:32000],
                  default_utterance(5, 220.0).wav[:28000]),
        "long": (_long(7, 110.0), _long(8, 210.0)),
    }
    paths = {}
    for name, pair in wavs.items():
        paths[name] = []
        for side, wav in zip(("src", "trg"), pair):
            path = str(root / f"{name}_{side}.wav")
            wavfile.write(path, FS,
                          (np.clip(wav, -1, 1) * 32767).astype(np.int16))
            paths[name].append(path)
    jcfg, cfg = JaxConfig(**SMALL), SpeechSplitConfig(**SMALL)
    _, g_state = create_train_state(jcfg, jax.random.PRNGKey(0))
    _, p_state = create_train_state(jcfg, jax.random.PRNGKey(1),
                                    "f0_converter")
    ckpts = []
    for model, params, tag in (
            (SpeechSplit(cfg, torch.Generator()), g_state.params,
             "speechsplit"),
            (F0Converter(cfg, torch.Generator()), p_state.params,
             "f0_converter")):
        model.load_state_dict(jax_params_to_state_dict(params, tag))
        path = str(root / f"{tag}.ckpt")
        torch.save({"model": model.state_dict()}, path)
        ckpts.append(path)
    port = VoiceConverter.from_checkpoints(*ckpts, config=cfg, device="cpu",
                                           dither_draws=_jax_draws)
    ref = JaxVoiceConverter(jcfg, g_state.params, p_state.params)
    return port, ref, paths


def _edge_frames(n_samples, hop=256, span=440):
    """The frames whose lagged windows reach past the utterance's end into
    the zero padding: there the NCCF's normalization sits on its 1e-12
    floor and JAX's value is its float32 FFT rounding times up to 1e6."""
    return {t for t in range(n_samples // hop + 1) if t * hop + span
            > n_samples}


def _jax_track(wav, gender):
    """What JAX's extractor tracks for a wav (preprocess.py:113-127,
    pitch.py:599-617): its dithered signal y [1, N], its log-F0 track and
    its candidate field (lag, score [T, K])."""
    batch, lengths = jpre.pad_batch([wav])
    uniform = jax.random.uniform(jax.random.PRNGKey(0), batch.shape)
    y = jnp.asarray(batch) * 0.96 + (uniform - 0.5) * 2.0 * 1e-6
    lo, hi = (jnp.float32(v) for v in GENDER_F0_RANGE[gender])
    logf0 = jpitch.track_pitch(y, jnp.asarray(lengths), lo[None], hi[None])
    frames = batch.shape[1] // 256 + 1
    x = jnp.pad(y[0], (0, (frames - 1) * 256 + 440))
    nccf = jpitch._nccf(x, frames, 256, 120, 26, 320)
    lag, score = jpitch._candidates(nccf, 26, jpitch.PitchParams())
    in_range = (lag >= 16000 / hi) & (lag <= 16000 / lo)
    return (np.array(y), lengths, np.asarray(logf0)[0],
            (lag, jnp.where(in_range, score, -2.0)))


def _bins(f0):
    return np.asarray(jax_quantize_f0(jnp.asarray(f0)))


@pytest.mark.parametrize("pair", ["short", "long"])
def test_convert_wav_files_equals_jax(setup, pair, monkeypatch):
    """The F0 tracks first, frame for frame: the voicing of every frame,
    and the log-F0 of every frame but an utterance's last ones
    (``_edge_frames``), whose lag JAX takes from its FFT's rounding.
    There the port's decoder, given JAX's own candidate field, decodes
    JAX's track exactly: the frame differs in the NCCF, not in the
    decoder (ROADMAP.md C, limits). The speaker normalization's mean and
    std carry such a frame's log-F0 to every normalized value (a few
    1e-4), which can move a frame across a quantization bin: the count
    of such frames a side is pinned (``BINS_OFF``). The seven mels within
    5e-5 from JAX's features through the port's conversion path, and end
    to end on every condition whose F0 side has every bin equal to JAX's
    (the conditions with F take the target's F0, the others the
    source's)."""
    port, ref, paths = setup
    features, bins_off = {}, {}
    for path, gender in zip(paths[pair], ("M", "F")):
        wav = read_wav(path)
        mel_t, f0_t = port.extract_features_full(wav, gender)
        mel_j, f0_j = ref.extract_features_full(wav, gender)
        features[gender] = (mel_j, f0_j)
        np.testing.assert_allclose(mel_t, mel_j, rtol=0, atol=1e-5)

        y, lengths, logf0_j, (lag, score) = _jax_track(wav, gender)
        logf0_t = pitch.track_pitch(
            torch.from_numpy(y), torch.from_numpy(lengths),
            torch.tensor(GENDER_F0_RANGE[gender][:1]),
            torch.tensor(GENDER_F0_RANGE[gender][1:]))[0].numpy()
        np.testing.assert_array_equal(logf0_t > -1e9, logf0_j > -1e9)
        voiced = logf0_j > -1e9
        off = set(np.nonzero(voiced & (np.abs(logf0_t - logf0_j) > 1e-5))[0]
                  .tolist())
        assert off <= _edge_frames(len(wav)), (path, sorted(off))
        best_j, voiced_j = jpitch._viterbi_scan(lag, score, 320,
                                                jpitch.PitchParams())
        best_t, voiced_t = pitch._viterbi(
            torch.from_numpy(np.array(lag))[None],
            torch.from_numpy(np.array(score))[None], 320, pitch.PitchParams())
        np.testing.assert_array_equal(voiced_t[0].numpy(), voiced_j)
        np.testing.assert_array_equal(best_t[0].numpy(), best_j)
        bins_off[gender] = int((_bins(f0_t) != _bins(f0_j)).sum())
    assert (len(mel_t) > 192) == (pair == "long")
    assert bins_off == BINS_OFF[pair]

    want = ref.convert_wav_files(*paths[pair], synthesize=False)
    with monkeypatch.context() as patch:
        patch.setattr(port, "extract_features_full",
                      lambda wav, gender: features[gender])
        on_jax_features = port.convert_wav_files(*paths[pair],
                                                 synthesize=False)
    end_to_end = port.convert_wav_files(*paths[pair], synthesize=False)
    conditions = {"R", "F", "U", "RF", "RU", "FU", "RFU"}
    reached = [c for c in sorted(conditions)
               if not bins_off["F" if "F" in c else "M"]]
    assert len(reached) == {"short": 3, "long": 7}[pair], reached
    for got, which in ((on_jax_features, conditions), (end_to_end, reached)):
        assert set(got) == set(want) == conditions
        for condition in which:
            assert got[condition]["mel"].shape == want[condition]["mel"].shape
            np.testing.assert_allclose(got[condition]["mel"],
                                       want[condition]["mel"], rtol=0,
                                       atol=ATOL)
    assert set(port.last_timings) == {"features_ms", "convert_ms",
                                      "vocoder_ms"}


def test_same_input_same_output_and_wavs(setup):
    port, _, paths = setup
    runs = [port.convert_wav_files(*paths["short"], conditions=("R", "RFU"),
                                   pcm16=True) for _ in range(2)]
    for condition in ("R", "RFU"):
        np.testing.assert_array_equal(runs[0][condition]["mel"],
                                      runs[1][condition]["mel"])
        np.testing.assert_array_equal(runs[0][condition]["wav"],
                                      runs[1][condition]["wav"])
        wav, mel = runs[0][condition]["wav"], runs[0][condition]["mel"]
        assert wav.dtype == np.int16 and len(wav) == (len(mel) - 1) * 256


def test_compress_results_rounds_as_jax(setup, monkeypatch):
    """On JAX's features (see ``test_convert_wav_files_equals_jax``)."""
    port, ref, paths = setup
    features = {gender: ref.extract_features_full(read_wav(path), gender)
                for path, gender in zip(paths["short"], ("M", "F"))}
    monkeypatch.setattr(port, "extract_features_full",
                        lambda wav, gender: features[gender])
    exact = port.convert_wav_files(*paths["short"], synthesize=False)
    got = port.convert_wav_files(*paths["short"], synthesize=False,
                                 compress_results=True)
    want = ref.convert_wav_files(*paths["short"], synthesize=False,
                                 compress_results=True)
    for condition, entry in got.items():
        mel = entry["mel"]
        assert mel.dtype == np.float32
        # JAX's cast of the port's own float32 grid: the same rounding
        np.testing.assert_array_equal(
            mel, np.asarray(jnp.asarray(exact[condition]["mel"]).astype(
                jnp.bfloat16).astype(jnp.float32)))
        # and one bfloat16 ulp at most from JAX's compressed result
        ref_mel = np.abs(want[condition]["mel"]).astype(np.float64)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(ref_mel, 1e-30))) - 7)
        assert (np.abs(mel - want[condition]["mel"]) <= ulp).all()
    # "auto": the link profile decides, as JAX's choose_compress does for
    # the same bytes (7 conditions of one pair)
    grid = len(CONDITIONS) * port.config.max_len_pad * 80 * 4
    for link, compressed in ((TUNNEL, True), (FAST, False)):
        monkeypatch.setattr(linkprobe, "_CACHED", linkprobe.LinkProfile(
            *link))
        assert port._resolve_compress("auto", 1, CONDITIONS) is (
            compressed)
        assert jlinkprobe.choose_compress(
            grid, profile=jlinkprobe.LinkProfile(*link)) is compressed
    assert port._resolve_compress(False, 1, CONDITIONS) is False
    assert port._resolve_compress(True, 1, CONDITIONS) is True


def test_refused_options(setup, tmp_path):
    port, _, _ = setup
    with pytest.raises(NotImplementedError, match="ROADMAP.md A2"):
        VoiceConverter.from_checkpoints(str(tmp_path / "1-G"),
                                        str(tmp_path / "1-P"), device="cpu")
    # a one-hot generator has no speaker encoder (learned mode is
    # tests/test_torch_learned_pipeline.py's)
    with pytest.raises(ValueError, match="learned"):
        port.speaker_embedding_from_mel(np.zeros((10, 80), np.float32))
    with pytest.raises(ValueError, match="spk_emb"):
        port.extract_utterance(np.zeros(4000, np.float32))


def test_entry_points_default_to_cuda(setup, monkeypatch):
    from speechsplit_tpu_torch.preprocess import extract_features
    from speechsplit_tpu_torch.vocoder import GriffinLimVocoder

    port, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VoiceConverter(port.config, port.g_model, port.p_model)
    with pytest.raises(RuntimeError, match="CUDA"):
        GriffinLimVocoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_features(np.zeros((1, 4096), np.float32), [4096], [50.0],
                         [250.0], generator=torch.Generator())
