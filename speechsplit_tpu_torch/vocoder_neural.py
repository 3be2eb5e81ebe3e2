"""The neural vocoder, inference and training (counterpart of
speechsplit_tpu/vocoder_neural.py).

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
computes the vocoder, in training too.

Training (:class:`VocoderTrainer`, ``cli.train_vocoder``): aligned (mel,
wav) crops of the repo's own front-end features, a multi-resolution STFT
loss plus a mel dB term, and optax's ``adamw`` (weight decay 1e-4 on
every parameter, a warmup-and-cosine schedule read at the count before
each update) as ``training.train_step.Adam`` computes it. A new model
draws JAX's initializers from an explicit ``torch.Generator``
(:func:`init_model`). The resident path keeps the corpus on the card and
gathers K steps' crops there between two host reads of the loss.

Weights: a packed ``.npz`` of ``/``-joined flax keys
(:func:`npz_to_state_dict`): the shipped float16
``assets/vocoder_istft_100k.npz`` (``load_vocoder("default")``), a
trainer checkpoint ``{iters}-V.npz`` (float32, :func:`save_vocoder`; the
JAX trainer writes an Orbax directory there) or a float16 export
(:func:`export_vocoder_npz`). The architecture (channels, depth, n_fft)
comes from the shapes.
"""

from __future__ import annotations

import math
import os
import zipfile
from typing import Callable, Dict, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.models.layers import _uniform, _xavier
from speechsplit_tpu_torch.ops.stft import (
    exact_float32,
    magnitude_stft,
    mel_basis,
)
from speechsplit_tpu_torch.training.train_step import Adam
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

    def head_out(self, mel: torch.Tensor) -> torch.Tensor:
        """The head's output [B, T, 3 * (n_fft//2+1)], before the split
        and the clamp: the network's smooth part (its layers, norms and
        GELUs)."""
        x = self.embed(mel)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        return self.head(self.final_norm(x))

    def forward(self, mel: torch.Tensor):
        log_mag, p_cos, p_sin = self.head_out(mel).chunk(3, dim=-1)
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
        arr = np.array(value, dtype=np.float32)
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
    the parameters' shapes: the shipped float16 asset, a trainer's
    float32 ``{iters}-V.npz`` or an export. An Orbax checkpoint directory
    (the JAX trainer's format) raises ``NotImplementedError`` (ROADMAP.md
    A7; JAX's ``export_vocoder_npz`` brings one in); a missing path
    ``FileNotFoundError``."""
    if path == "default":
        path = default_checkpoint()
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: the port reads no Orbax vocoder checkpoint directory "
            "(ROADMAP.md A7); the JAX package's export_vocoder_npz packs "
            "one into a .npz, and the port's cli.train_vocoder writes .npz")
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


# ------------------------------------------------------------- training

WEIGHT_DECAY = 1e-4  # optax.adamw's, on every parameter (no mask)
LOSS_RESOLUTIONS = ((512, 128), (1024, 256), (2048, 512))
MEL_LOSS_SCALE = 0.05  # the mel dB term's share, times mel_weight
END_FRACTION = 0.05  # the schedule's last learning rate over its peak


def init_model(generator: torch.Generator, n_fft: int = 1024,
               hop: int = 256, channels: int = 256, depth: int = 6,
               n_mels: int = 80) -> NeuralVocoderModel:
    """A new ``NeuralVocoderModel`` on the CPU with the JAX package's
    initializers (models/layers.py:60-135), drawn from ``generator``: a
    ``Linear`` or conv weight Xavier-uniform at gain 1 (a conv's fans
    ``k * in`` and ``k * out``), its bias U(+-1/sqrt(fan_in)), a
    LayerNorm's scale 1 and bias 0."""
    with torch.device("meta"):  # no default initializer draws
        model = NeuralVocoderModel(n_fft, hop, channels, depth, n_mels)
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                fan_in, fan_out = module.in_features, module.out_features
            elif isinstance(module, nn.Conv1d):
                k = module.kernel_size[0]
                fan_in = k * module.in_channels
                fan_out = k * module.out_channels
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                continue
            else:
                continue
            module.weight.copy_(_xavier(module.weight.shape, fan_in, fan_out,
                                        "linear", generator))
            module.bias.copy_(_uniform(module.bias.shape,
                                       1.0 / math.sqrt(fan_in), generator))
    return model


def warmup_cosine_lr(peak: float, total_steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup_steps=
    min(500, total_steps // 10), decay_steps=total_steps, end_value=
    0.05 * peak)`` (vocoder_neural.py:194-201) as a function of the update
    count, in float32 as JAX computes it: linear from 0 over the warmup
    (so count 0 gives exactly 0), then a cosine to the end value."""
    warmup = min(500, total_steps // 10)
    end = END_FRACTION * peak
    alpha = 0.0 if peak == 0.0 else end / peak
    f32 = np.float32
    span = total_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        t = min(f32(count - warmup), f32(span))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(span)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def multi_resolution_stft_loss(pred: torch.Tensor,
                               target: torch.Tensor) -> torch.Tensor:
    """Spectral convergence plus log-magnitude L1, averaged over the
    resolutions (vocoder_neural.py:131-152). The spectral convergence is
    one Frobenius norm over the whole batch's [B, T, F] difference over
    the target's, not a mean of per-utterance norms."""
    total = 0.0
    for n_fft, hop in LOSS_RESOLUTIONS:
        mp = magnitude_stft(pred, n_fft, hop)
        mt = magnitude_stft(target, n_fft, hop)
        sc = torch.linalg.norm(mt - mp) / torch.clamp(torch.linalg.norm(mt),
                                                      min=1e-6)
        logl1 = torch.mean(torch.abs(torch.log(mp + 1e-5)
                                     - torch.log(mt + 1e-5)))
        total = total + sc + logl1
    return total / len(LOSS_RESOLUTIONS)


def mel_db_l1(pred: torch.Tensor, target: torch.Tensor,
              basis: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """The mean |dB| difference of the two signals' mel spectrograms
    (vocoder_neural.py:155-163)."""
    with exact_float32():
        mp = torch.clamp(magnitude_stft(pred, n_fft, hop) @ basis, min=1e-5)
        mt = torch.clamp(magnitude_stft(target, n_fft, hop) @ basis,
                         min=1e-5)
    return torch.mean(torch.abs(20.0 * (torch.log10(mp) - torch.log10(mt))))


def make_crops(wavs: Sequence[np.ndarray], mels: Sequence[np.ndarray],
               batch: int, t_frames: int, hop: int,
               rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned random (mel, wav) crops for one batch on the host
    (vocoder_neural.py:313-340), the draws of JAX's for the same ``rng``:
    an utterance, then a start frame, a crop at a time; zeros past an
    utterance's end. Returns (mel [B, t_frames, M], wav
    [B, (t_frames-1)*hop])."""
    n_wav = (t_frames - 1) * hop
    mel_out = np.zeros((batch, t_frames, mels[0].shape[1]), np.float32)
    wav_out = np.zeros((batch, n_wav), np.float32)
    for i in range(batch):
        j = rng.randint(0, len(wavs))
        mel, wav = mels[j], wavs[j]
        s = rng.randint(0, max(len(mel) - t_frames, 0) + 1)
        m = mel[s : s + t_frames]
        mel_out[i, : len(m)] = m
        w = wav[s * hop : s * hop + n_wav]
        wav_out[i, : len(w)] = w
    return mel_out, wav_out


class ResidentCorpus:
    """The training corpus on the device, zero-padded, and crops gathered
    there: the resident path's counterpart of :func:`make_crops`.

    ``wavs[i]`` [N_i] and ``mels[i]`` [T_i, M] (T_i frames, one a ``hop``)
    are padded with zeros to the longest, and at least to one crop, so a
    crop past an utterance's end reads the zeros ``make_crops`` writes."""

    def __init__(self, wavs: Sequence[np.ndarray], mels: Sequence[np.ndarray],
                 crop_frames: int, hop: int, device):
        self.device = resolve_device(device)
        self.crop_frames, self.hop = crop_frames, hop
        self.n_wav = (crop_frames - 1) * hop
        t_pad = max(max(len(m) for m in mels), crop_frames)
        n_pad = max(max(len(w) for w in wavs), self.n_wav)
        mel_arr = np.zeros((len(mels), t_pad, mels[0].shape[1]), np.float32)
        wav_arr = np.zeros((len(wavs), n_pad), np.float32)
        for i, (m, w) in enumerate(zip(mels, wavs)):
            mel_arr[i, : len(m)] = m
            wav_arr[i, : len(w)] = w
        self.mels = torch.from_numpy(mel_arr).to(self.device)
        self.wavs = torch.from_numpy(wav_arr).to(self.device)
        # the largest start a crop of each utterance may take
        self.max_start = torch.tensor(
            [max(len(m) - crop_frames, 0) for m in mels],
            device=self.device)

    def __len__(self) -> int:
        return self.mels.shape[0]

    def gather(self, uid: torch.Tensor, start: torch.Tensor):
        """The crops of utterances ``uid`` [B] from frames ``start`` [B]
        (both long on the device): (mel [B, crop, M], wav [B, n_wav])."""
        rows = start[:, None] + torch.arange(self.crop_frames,
                                             device=self.device)
        cols = start[:, None] * self.hop + torch.arange(self.n_wav,
                                                        device=self.device)
        return self.mels[uid[:, None], rows], self.wavs[uid[:, None], cols]

    def draw(self, batch: int, generator: torch.Generator):
        """A batch of crops from picks drawn on the device as JAX's
        resident step draws them (vocoder_neural.py:273-279): a uniform
        utterance, then a start floor(u * (max_start + 1)) for u ~ U(0, 1);
        the stream differs from JAX's."""
        uid = torch.randint(0, len(self), (batch,), generator=generator,
                            device=self.device)
        frac = torch.rand(batch, generator=generator, device=self.device)
        most = self.max_start[uid]
        start = torch.minimum((frac * (most + 1)).long(), most)
        return self.gather(uid, start)


class VocoderState(NamedTuple):
    """The model, its optimizer and the count of steps taken."""

    model: NeuralVocoderModel
    optimizer: Adam
    step: int


class VocoderTrainer:
    """The neural vocoder's train step on ``device`` (``cuda`` unless
    given; vocoder_neural.py:166-311): the loss of :func:`loss_fn` on
    aligned (mel [B, T, M], wav [B, (T-1)*hop]) crops, its gradient and
    one adamw update, float32 with TF32 off. ``total_steps`` > 0 takes
    the warmup-and-cosine schedule (:func:`warmup_cosine_lr`); 0 a
    constant ``learning_rate``."""

    def __init__(
        self,
        n_fft: int = 1024,
        hop: int = 256,
        channels: int = 256,
        depth: int = 6,
        learning_rate: float = 2e-4,
        mel_weight: float = 1.0,
        sample_rate: int = 16000,
        n_mels: int = 80,
        fmin: float = 90.0,
        fmax: float = 7600.0,
        total_steps: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.n_fft, self.hop = n_fft, hop
        self.channels, self.depth, self.n_mels = channels, depth, n_mels
        self.lr = (warmup_cosine_lr(learning_rate, total_steps)
                   if total_steps else learning_rate)
        self.basis = mel_basis(sample_rate, n_fft, n_mels, fmin, fmax,
                               self.device)
        self.mel_weight = mel_weight

    def init(self, seed=0) -> VocoderState:
        """A new model (:func:`init_model`, from ``seed``: an int or a CPU
        ``torch.Generator``) and a fresh optimizer."""
        generator = seed if isinstance(seed, torch.Generator) else (
            torch.Generator().manual_seed(seed))
        model = init_model(generator, self.n_fft, self.hop, self.channels,
                           self.depth, self.n_mels)
        return self.state_from(model)

    def state_from(self, model: NeuralVocoderModel) -> VocoderState:
        """A state that trains ``model`` (moved to the device) from a
        fresh optimizer."""
        model = model.to(self.device).train()
        optimizer = Adam(model.parameters(), lr=self.lr,
                         weight_decay=WEIGHT_DECAY)
        return VocoderState(model, optimizer, 0)

    def loss_fn(self, model: NeuralVocoderModel, mel: torch.Tensor,
                wav: torch.Tensor) -> torch.Tensor:
        """The multi-resolution STFT loss of the model's waveform against
        ``wav``, plus ``mel_weight`` x 0.05 x the mel dB L1, in the
        model's dtype (float32 in training; a float64 model gives the
        reference the checks hold the float32 gradient to)."""
        dtype = next(model.parameters()).dtype
        with exact_float32():
            pred = model(mel.to(self.device, dtype))
        wav = wav.to(self.device, dtype)
        n = min(pred.shape[-1], wav.shape[-1])
        pred, wav = pred[..., :n], wav[..., :n]
        loss = multi_resolution_stft_loss(pred, wav)
        if self.mel_weight:
            loss = loss + self.mel_weight * MEL_LOSS_SCALE * mel_db_l1(
                pred, wav, self.basis.to(dtype), self.n_fft, self.hop)
        return loss

    def loss_and_grad(self, model: NeuralVocoderModel, mel: torch.Tensor,
                      wav: torch.Tensor) -> torch.Tensor:
        """:meth:`loss_fn` and its gradient, left in the parameters'
        ``grad``, the backward also with TF32 off; returns the loss
        (detached, on the device)."""
        model.zero_grad(set_to_none=True)
        loss = self.loss_fn(model, mel, wav)
        with exact_float32():
            loss.backward()
        return loss.detach()

    def step(self, state: VocoderState, mel: torch.Tensor,
             wav: torch.Tensor) -> Tuple[VocoderState, torch.Tensor]:
        """One update; returns the new state and the step's loss, a
        tensor on the device (no host read)."""
        model, optimizer, count = state
        loss = self.loss_and_grad(model, mel, wav)
        optimizer.step()
        return VocoderState(model, optimizer, count + 1), loss

    def make_resident_step(self, corpus: ResidentCorpus, batch: int,
                           k_steps: int):
        """The resident path (vocoder_neural.py:249-311) over a corpus on
        the device: ``fn(state, generator) -> (state, mean loss)`` takes
        ``k_steps`` steps on crops drawn there from ``generator`` (a
        ``torch.Generator`` on the device) and returns their mean loss as
        a device tensor: nothing is read on the host between two calls."""

        def dispatch(state: VocoderState, generator: torch.Generator):
            losses = []
            for _ in range(k_steps):
                state, loss = self.step(state, *corpus.draw(batch,
                                                            generator))
                losses.append(loss)
            return state, torch.stack(losses).mean()

        return dispatch


def state_dict_to_npz(state_dict: Mapping[str, torch.Tensor],
                      dtype=np.float32) -> Dict[str, np.ndarray]:
    """The inverse of :func:`npz_to_state_dict`: the port's state-dict
    keys -> ``/``-joined flax keys in ``dtype``: a ``Linear``'s ``weight
    [out, in]`` -> ``kernel [in, out]``, a conv's ``weight [out, in, k]``
    -> ``kernel [k, in, out]``, a LayerNorm's ``weight`` -> ``scale``."""
    flat = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf = {3: "kernel", 2: "kernel", 1: "scale"}[arr.ndim]
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
        elif leaf != "bias":
            raise ValueError(f"unrecognized vocoder parameter {key!r}")
        flat["/".join([*path, leaf])] = np.ascontiguousarray(arr, dtype)
    return flat


def save_vocoder(path: str, model: NeuralVocoderModel) -> str:
    """A trainer checkpoint: ``{path}.npz`` (``path`` itself if it ends
    in ``.npz``), float32 with flax's keys, which this package's and the
    JAX package's ``load_vocoder`` read. Returns the file's path. (The
    JAX trainer writes an Orbax directory at ``path`` instead.)"""
    path = os.path.abspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **state_dict_to_npz(model.state_dict()))
    return path


def export_vocoder_npz(path: str, model: NeuralVocoderModel,
                       dtype: str = "float16") -> str:
    """The shipping form (vocoder_neural.py:462-486): one compressed
    ``.npz`` of flax's keys in ``dtype``, as JAX's
    ``export_vocoder_npz`` writes it for the same weights."""
    np.savez_compressed(path, **state_dict_to_npz(model.state_dict(),
                                                  dtype))
    return os.path.abspath(path)
