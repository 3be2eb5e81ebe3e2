"""Wav files in, converted wavs out (counterpart of
speechsplit_tpu/pipeline.py).

One object holds the two models, the feature front end and the vocoder:

    vc = VoiceConverter.from_checkpoints("660000-G.ckpt", "640000-P.ckpt")
    results = vc.convert_wav_files("src.wav", "trg.wav",
                                   src_gender="M", trg_gender="F")

A request runs feature extraction on the card (``preprocess``: STFT,
mel, the NCCF pitch tracker with its Viterbi kernel), ``convert_batched``
(``convert_long`` past ``max_len_pad`` frames) and Griffin-Lim
synthesis (or the neural vocoder, ``vocoder_neural.load_vocoder``),
quantized to PCM16 on the card when asked. Everything runs on ``cuda``
unless ``device="cpu"`` is given.

The dither draws of each extraction come from a CPU ``torch.Generator``
reseeded from ``seed`` on every call (or from ``dither_draws``, a
function of the padded batch's shape that tests use to inject JAX's
draws), and the vocoder reseeds its own: the same input gives the same
output, as JAX's fixed key does (pipeline.py:113-125).

A learned-mode generator (``spk_emb_mode="learned"``) converts zero-shot:
each file's timbre target is its own mel's SpeakerEncoder embedding
(:meth:`VoiceConverter.speaker_embedding_from_mel`) unless one is passed.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from speechsplit_tpu_torch import linkprobe, resolve_device
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.convert import (
    CONDITIONS,
    Utterance,
    convert_batched,
    convert_long,
    prepare_utterance,
)
from speechsplit_tpu_torch.data.prepare import read_wav
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.ops.masks import pad_time_axis
from speechsplit_tpu_torch.preprocess import (
    GENDER_F0_RANGE,
    extract_features,
    frame_count,
    pad_batch,
)
from speechsplit_tpu_torch.vocoder import GriffinLimVocoder, Vocoder


class VoiceConverter:
    """Loaded models, feature front end and vocoder, ready to convert."""

    def __init__(
        self,
        config: SpeechSplitConfig,
        g_model: SpeechSplit,
        p_model: F0Converter,
        vocoder: Optional[Vocoder] = None,
        seed: int = 0,
        device=None,
        dither_draws: Optional[Callable[[tuple], torch.Tensor]] = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.g_model = g_model.to(self.device).eval()
        self.p_model = p_model.to(self.device).eval()
        self.vocoder = vocoder or GriffinLimVocoder(
            sample_rate=config.sample_rate, n_fft=config.fft_length,
            hop=config.hop_length, n_mels=config.dim_freq,
            fmin=config.mel_fmin, fmax=config.mel_fmax, seed=seed,
            device=self.device,
        )
        self.seed = seed
        self.dither_draws = dither_draws
        # host-clock ms of the last convert_wav_files call's stages, each
        # ending in its fetch to the host
        self.last_timings: Dict[str, float] = {}

    @classmethod
    def from_checkpoints(
        cls,
        generator_path: str,
        f0_converter_path: str,
        config: Optional[SpeechSplitConfig] = None,
        **kwargs,
    ) -> "VoiceConverter":
        """Load reference-format ``.ckpt`` files (the reference's own, or
        ones the JAX package's ``cli.export_ckpt`` or the port's trainer
        wrote)."""
        from speechsplit_tpu_torch.interop import load_reference_checkpoint

        config = config or SpeechSplitConfig()
        for path in (generator_path, f0_converter_path):
            if not path.endswith(".ckpt"):
                raise NotImplementedError(
                    f"{path}: only reference-format .ckpt files load here; "
                    "Orbax checkpoint directories reach the port through "
                    "the JAX package's cli.export_ckpt (ROADMAP.md A2)")
        g_model = SpeechSplit(config)
        g_model.load_state_dict(load_reference_checkpoint(generator_path))
        p_model = F0Converter(config)
        p_model.load_state_dict(load_reference_checkpoint(f0_converter_path))
        return cls(config, g_model, p_model, **kwargs)

    # ------------------------------------------------------------------
    def _draws(self, shape: tuple) -> torch.Tensor:
        if self.dither_draws is not None:
            return self.dither_draws(shape)
        return torch.rand(shape,
                          generator=torch.Generator().manual_seed(self.seed))

    def extract_features_full(self, wav: np.ndarray, gender: str = "M"
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """wav [N] -> (mel [T, 80], f0 [T]) at full length, on the host."""
        cfg = self.config
        lo, hi = GENDER_F0_RANGE[gender]
        batch, lengths = pad_batch([wav])
        mel, f0 = extract_features(
            batch, lengths, np.full(1, lo, np.float32),
            np.full(1, hi, np.float32), uniform=self._draws(batch.shape),
            device=self.device, sample_rate=cfg.sample_rate,
            n_fft=cfg.fft_length, hop=cfg.hop_length, n_mels=cfg.dim_freq,
            fmin=cfg.mel_fmin, fmax=cfg.mel_fmax,
        )
        t = frame_count(len(wav), cfg.hop_length)
        return mel[0, :t].cpu().numpy(), f0[0, :t].cpu().numpy()

    @torch.inference_mode()
    def speaker_embedding_from_mel(self, mel: np.ndarray) -> np.ndarray:
        """Learned mode's zero-shot timbre embedding [1, dim_spk_emb] of
        (up to ``max_len_pad`` frames of) a mel, zero-padded to
        ``max_len_pad`` as training and conversion embed it."""
        cfg = self.config
        t = min(len(mel), cfg.max_len_pad)
        mel_pad, _ = pad_time_axis(np.asarray(mel[:t], np.float32)[None],
                                   cfg.max_len_pad)
        emb = self.g_model.embed_speaker(
            torch.from_numpy(mel_pad).to(self.device))
        return emb.cpu().numpy()

    def extract_utterance(self, wav: np.ndarray,
                          spk_emb: Optional[np.ndarray] = None,
                          gender: str = "M", name: str = "",
                          uid: str = "") -> Utterance:
        """wav [N] -> a prepared Utterance, cut to ``max_len_pad`` frames
        (:meth:`convert_wav_files` windows longer audio). ``spk_emb=None``
        takes the utterance's own embedding in learned mode; a one-hot
        config needs one."""
        if spk_emb is None and self.config.spk_emb_mode != "learned":
            raise ValueError(
                "spk_emb is required for one-hot configs "
                "(spk_emb_mode='learned' derives it from the mel)")
        mel, f0 = self.extract_features_full(wav, gender)
        t = min(len(mel), self.config.max_len_pad)
        if spk_emb is None:
            spk_emb = self.speaker_embedding_from_mel(mel)
        return prepare_utterance(self.config, mel[:t], f0[:t], spk_emb,
                                 name=name, uid=uid, device=self.device)

    def _resolve_compress(self, mode, n_pairs: int, conditions) -> bool:
        """Resolve a ``compress_results`` of ``"auto"`` (JAX
        pipeline.py:189-204): a single request has no stream to time, so
        the once-a-process link probe decides, and the grid is fetched as
        bfloat16 only where its float32 fetch would dominate the request
        (a slow link); a card in this host fetches float32."""
        if mode != "auto":
            return bool(mode)
        t = self.config.max_len_pad
        bytes_f32 = len(conditions) * n_pairs * t * self.config.dim_freq * 4
        return linkprobe.choose_compress(
            bytes_f32, profile=linkprobe.probe_link(device=self.device))

    def convert_utterances(self, src: Utterance, trg: Utterance,
                           conditions: Sequence[str] = CONDITIONS,
                           compress_results=False
                           ) -> List[Tuple[str, np.ndarray]]:
        return convert_batched(
            self.g_model, self.p_model, [(src, trg)], conditions,
            compress_fetch=self._resolve_compress(compress_results, 1,
                                                   conditions),
        )[0]

    def convert_wav_files(
        self,
        src_path: str,
        trg_path: str,
        *,
        src_gender: str = "M",
        trg_gender: str = "F",
        src_emb: Optional[np.ndarray] = None,
        trg_emb: Optional[np.ndarray] = None,
        conditions: Sequence[str] = CONDITIONS,
        synthesize: bool = True,
        compress_results=False,
        pcm16: bool = False,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Wav-to-wav conversion between two utterance files.

        Past ``max_len_pad`` frames the pair goes through ``convert_long``,
        one call a condition. Returns {condition: {"mel": [T, 80],
        "wav": [N]}} ("wav" when ``synthesize``). ``compress_results``
        fetches the mels as bfloat16 ("auto": the link probe decides, see
        :meth:`_resolve_compress`); ``pcm16`` returns int16 wavs quantized
        on the device.
        Speaker embeddings default to one-hot slots 1 (source) and 7
        (target), as JAX's; in learned mode to each file's own
        embedding (from its full mel, for ``convert_long`` too)."""
        cfg = self.config
        clock = time.perf_counter()
        s_mel, s_f0 = self.extract_features_full(
            read_wav(src_path, cfg.sample_rate), src_gender)
        t_mel, t_f0 = self.extract_features_full(
            read_wav(trg_path, cfg.sample_rate), trg_gender)
        timings = {"features_ms": (time.perf_counter() - clock) * 1e3}

        clock = time.perf_counter()
        if cfg.spk_emb_mode == "learned":
            if src_emb is None:
                src_emb = self.speaker_embedding_from_mel(s_mel)
            if trg_emb is None:
                trg_emb = self.speaker_embedding_from_mel(t_mel)
        else:
            eye = np.eye(cfg.dim_spk_emb, dtype=np.float32)
            src_emb = eye[1] if src_emb is None else src_emb
            trg_emb = eye[7] if trg_emb is None else trg_emb
        if max(len(s_mel), len(t_mel)) <= cfg.max_len_pad:
            src = prepare_utterance(cfg, s_mel, s_f0, src_emb,
                                    name=os.path.basename(src_path), uid="0",
                                    device=self.device)
            trg = prepare_utterance(cfg, t_mel, t_f0, trg_emb,
                                    name=os.path.basename(trg_path), uid="0",
                                    device=self.device)
            results = self.convert_utterances(
                src, trg, conditions, compress_results=compress_results)
            named = [(n.split("_")[-1], mel) for n, mel in results]
        else:
            named = [(condition, convert_long(
                cfg, self.g_model, self.p_model, s_mel, s_f0, src_emb,
                t_mel, t_f0, trg_emb, condition=condition))
                for condition in conditions]
        timings["convert_ms"] = (time.perf_counter() - clock) * 1e3

        clock = time.perf_counter()
        wavs = None
        if synthesize and hasattr(self.vocoder, "synthesize_batch"):
            wavs = self.vocoder.synthesize_batch([m for _, m in named],
                                                 pcm16=pcm16)
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for i, (condition, mel) in enumerate(named):
            entry = {"mel": mel}
            if synthesize:
                entry["wav"] = wavs[i] if wavs is not None else (
                    self.vocoder(mel))
            out[condition] = entry
        timings["vocoder_ms"] = (time.perf_counter() - clock) * 1e3
        self.last_timings = timings
        return out
