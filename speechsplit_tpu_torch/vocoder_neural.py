"""The neural vocoder, inference (counterpart of
speechsplit_tpu/vocoder_neural.py:39-120, 345-549).

A dilated-conv backbone (``MelToSpec``: an embedding ``Linear``, six
ConvNeXt-style blocks at dilations 1, 2, 4, a final LayerNorm and a
``Linear`` head) predicts each STFT bin's log-magnitude (clipped to
[-11, 5]) and phase as a cos/sin pair; ``NeuralVocoderModel.spec``
normalizes the phase and the waveform comes from the port's inverse STFT
(``vocoder._istft``). ``refine_iters`` mel-consistency projections
(``vocoder.mel_consistency_project``, momentum 0.9) may follow on the
predicted spectrum before the final iSTFT: the network supplies the
phase that Griffin-Lim spends its random-start iterations recovering.

The layers keep flax's conventions, which differ from torch's defaults:
LayerNorm over the last axis with epsilon 1e-6 and the variance as
E[x^2] - E[x]^2 (clipped at 0), GELU in its tanh form. Every product
(the convs in cuDNN, the ``Linear`` layers in cuBLAS) runs in full
float32 with TF32 off (``ops.stft.exact_float32``), as the JAX package
computes the vocoder.

Weights: the JAX package's packed ``.npz`` (``/``-joined flax keys,
float16; the shipped ``assets/vocoder_istft_100k.npz``) through
:func:`npz_to_state_dict`; ``load_vocoder("default")`` loads that asset.
The architecture (channels, depth, n_fft) comes from the shapes. The
vocoder's trainer and its Orbax checkpoint directories wait in
ROADMAP.md A7.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.ops.stft import exact_float32, mel_basis
from speechsplit_tpu_torch.vocoder import (
    _istft,
    _peak_norm_pcm16,
    mel_consistency_project,
)

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default
HIDDEN_MULT = 3  # a block's MLP width over its channels
LOG_MAG_RANGE = (-11.0, 5.0)
PHASE_EPS = 1e-7
BUCKET_FRAMES = 32
DEFAULT_ASSET = "vocoder_istft_100k.npz"


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (float32 statistics, the
    variance E[x^2] - E[x]^2 clipped at 0, epsilon 1e-6); its ``scale``
    is ``weight`` here."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp(x.square().mean(dim=-1, keepdim=True)
                          - mean.square(), min=0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * self.weight
        return (x - mean) * mul + self.bias


class ConvNeXtBlock(nn.Module):
    """x + mlp_out(gelu(mlp_in(norm(conv_time(x))))) on [B, T, C], the
    conv dilated, kernel 5, 'same'-padded."""

    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.conv_time = nn.Conv1d(channels, channels, 5, dilation=dilation,
                                   padding=2 * dilation)
        self.norm = LayerNorm(channels)
        self.mlp_in = nn.Linear(channels, HIDDEN_MULT * channels)
        self.mlp_out = nn.Linear(HIDDEN_MULT * channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_time(x.transpose(1, 2)).transpose(1, 2)
        y = F.gelu(self.mlp_in(self.norm(y)), approximate="tanh")
        return x + self.mlp_out(y)


class MelToSpec(nn.Module):
    """mel [B, T, M] -> (log_mag, cos, sin), each [B, T, n_fft//2+1]."""

    def __init__(self, n_fft: int = 1024, channels: int = 256,
                 depth: int = 6, n_mels: int = 80):
        super().__init__()
        self.embed = nn.Linear(n_mels, channels)
        for i in range(depth):
            setattr(self, f"block_{i}",
                    ConvNeXtBlock(channels, dilation=(1, 2, 4)[i % 3]))
        self.depth = depth
        self.final_norm = LayerNorm(channels)
        self.head = nn.Linear(channels, 3 * (n_fft // 2 + 1))

    def forward(self, mel: torch.Tensor):
        x = self.embed(mel)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        log_mag, p_cos, p_sin = self.head(self.final_norm(x)).chunk(3, dim=-1)
        return torch.clamp(log_mag, *LOG_MAG_RANGE), p_cos, p_sin


class NeuralVocoderModel(nn.Module):
    """mel [B, T, M] -> waveform [B, (T-1)*hop]."""

    def __init__(self, n_fft: int = 1024, hop: int = 256, channels: int = 256,
                 depth: int = 6, n_mels: int = 80):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.backbone = MelToSpec(n_fft, channels, depth, n_mels)

    def spec(self, mel: torch.Tensor) -> torch.Tensor:
        """The predicted complex STFT [B, T, F]: magnitude times the
        normalized (cos, sin) phase."""
        log_mag, p_cos, p_sin = self.backbone(mel)
        norm = torch.rsqrt(p_cos.square() + p_sin.square() + PHASE_EPS)
        mag = torch.exp(log_mag)
        return torch.complex(mag * p_cos * norm, mag * p_sin * norm)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return _istft(self.spec(mel), self.n_fft, self.hop)


def npz_to_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The packed vocoder's ``/``-joined flax keys -> the port's
    ``NeuralVocoderModel`` state dict, widened to float32: a ``Linear``'s
    ``kernel [in, out]`` -> ``weight [out, in]``, a conv's ``kernel [k,
    in, out]`` -> ``weight [out, in, k]``, a LayerNorm's ``scale`` ->
    ``weight``; biases as they are."""
    out = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{key}: a kernel of shape {arr.shape}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unrecognized vocoder parameter {key!r}")
        out[".".join([*path, leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


class NeuralVocoder:
    """The vocoder protocol over a ``NeuralVocoderModel`` with the given
    weights (a state dict of :func:`npz_to_state_dict`'s keys), on
    ``device`` (``cuda`` unless given). Input is the pipeline's
    normalized mel ([0, 1], make_spect_f0.py:58-61), as the model was
    trained. ``refine_iters`` > 0 runs that many mel-consistency
    projections on the predicted spectrum (momentum
    ``refine_momentum``) before the final iSTFT."""

    def __init__(
        self,
        state_dict: Mapping[str, torch.Tensor],
        n_fft: int = 1024,
        hop: int = 256,
        channels: int = 256,
        depth: int = 6,
        sample_rate: int = 16000,
        refine_iters: int = 0,
        refine_momentum: float = 0.9,
        n_mels: int = 80,
        fmin: float = 90.0,
        fmax: float = 7600.0,
        ref_level_db: float = 16.0,
        device=None,
    ):
        self.device = resolve_device(device)
        with torch.device("meta"):  # no initializer draws
            model = NeuralVocoderModel(n_fft, hop, channels, depth, n_mels)
        model.load_state_dict(state_dict, strict=True, assign=True)
        self.model = model.to(self.device).eval()
        self.n_fft, self.hop = n_fft, hop
        self.sample_rate = sample_rate
        self.refine_iters = refine_iters
        self.refine_momentum = refine_momentum
        self.ref_level_db = ref_level_db
        self.basis = mel_basis(sample_rate, n_fft, n_mels, fmin, fmax,
                               self.device) if refine_iters else None

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        return self.synthesize_batch([np.asarray(mel)])[0]

    @torch.inference_mode()
    def spectrum(self, mel: torch.Tensor) -> torch.Tensor:
        """The head's complex spectrum [B, T, F] of mel [B, T, M] on the
        vocoder's device (no refinement)."""
        with exact_float32():
            return self.model.spec(mel.to(self.device, torch.float32))

    @torch.inference_mode()
    def waveforms(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M] -> waveforms [B, (T-1)*hop], refined when
        ``refine_iters`` > 0."""
        mel = mel.to(self.device, torch.float32)
        spec = self.spectrum(mel)
        if self.refine_iters:
            # normalized dB -> linear amplitude (make_spect_f0.py:58-61)
            db = mel * 100.0 - 100.0 + self.ref_level_db
            amp = torch.pow(10.0, db / 20.0)
            spec = mel_consistency_project(
                spec, amp, self.basis, self.n_fft, self.hop,
                self.refine_iters, momentum=self.refine_momentum)
        return _istft(spec, self.n_fft, self.hop)

    def synthesize_batch(self, mels: list, pcm16: bool = False) -> list:
        """Synthesize many mels in one batch, padded with zero frames to
        a common length rounded up to 32 frames, each output trimmed to
        its (T-1)*hop samples and peak-normalized to 0.9. ``pcm16=True``
        normalizes and quantizes on the device and returns int16 arrays
        (see ``GriffinLimVocoder.synthesize_batch``)."""
        t_max = -(-max(len(m) for m in mels) // BUCKET_FRAMES) * BUCKET_FRAMES
        batch = np.zeros((len(mels), t_max, mels[0].shape[1]), np.float32)
        for i, m in enumerate(mels):
            batch[i, : len(m)] = m
        wavs = self.waveforms(torch.from_numpy(batch))
        lens = np.array([(len(m) - 1) * self.hop for m in mels])
        if pcm16:
            q = _peak_norm_pcm16(wavs, torch.from_numpy(lens)).cpu().numpy()
            return [q[i, :n] for i, n in enumerate(lens)]
        wavs = wavs.cpu().numpy().astype(np.float32)
        out = []
        for i, n in enumerate(lens):
            w = wavs[i, :n]
            peak = max(float(np.abs(w).max()), 1e-5)
            out.append((w / peak * 0.9).astype(np.float32))
        return out


def default_checkpoint() -> str:
    """The path of the pretrained vocoder shipped in the repo checkout
    (``assets/vocoder_istft_100k.npz``); ``--vocoder_ckpt default`` names
    it."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", DEFAULT_ASSET)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"pretrained vocoder asset not found at {path} (not a repo "
            "checkout?); pass an explicit checkpoint")
    return path


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a packed vocoder ``.npz``; a file that cannot be
    read as one raises ``ValueError`` naming it."""
    try:
        with np.load(path) as z:
            return {key: z[key] for key in z.files}
    except (OSError, ValueError, zipfile.BadZipFile) as exc:
        raise ValueError(f"{path}: not a readable vocoder .npz ({exc})"
                         ) from exc


def load_vocoder(
    path: str,
    hop: int = 256,
    sample_rate: int = 16000,
    refine_iters: int = 0,
    refine_momentum: float = 0.9,
    device=None,
) -> NeuralVocoder:
    """A trained vocoder from a packed ``.npz`` (or ``"default"``, the
    shipped asset), its architecture (channels, depth, n_fft) read from
    the parameters' shapes. An Orbax checkpoint directory (the JAX
    trainer's format) raises ``NotImplementedError`` (ROADMAP.md A7); a
    missing path ``FileNotFoundError``."""
    if path == "default":
        path = default_checkpoint()
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: Orbax vocoder checkpoint directories are queued with "
            "the vocoder trainer in ROADMAP.md A7; pass a packed .npz")
    if not (os.path.isfile(path) and path.endswith(".npz")):
        raise FileNotFoundError(f"no vocoder checkpoint at {path}")
    state = npz_to_state_dict(read_npz(path))
    if "backbone.embed.weight" not in state or (
            "backbone.head.weight" not in state):
        raise ValueError(f"{path}: no vocoder backbone (embed, head) in it")
    channels = int(state["backbone.embed.weight"].shape[0])
    depth = len({k.split(".")[1] for k in state
                 if k.startswith("backbone.block_")})
    f_bins = int(state["backbone.head.weight"].shape[0]) // 3
    return NeuralVocoder(
        state, n_fft=2 * (f_bins - 1), hop=hop, channels=channels,
        depth=depth, sample_rate=sample_rate, refine_iters=refine_iters,
        refine_momentum=refine_momentum,
        n_mels=int(state["backbone.embed.weight"].shape[1]), device=device)
