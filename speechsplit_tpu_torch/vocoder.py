"""Mel -> waveform synthesis (counterpart of speechsplit_tpu/vocoder.py).

The reference leaves synthesis to an external WaveNet (demo.ipynb
cell-1). The JAX package, and this port, ship a dependency-free
``GriffinLimVocoder``: a pseudo-inverse mel projection for the initial
magnitude, then fast Griffin-Lim (momentum, Perraudin et al. 2013) with
a mel-consistency projection in every iteration. The dB conventions
inverted are the front end's (make_spect_f0.py:58-61):
mel_amp = 10^((S*100 - 100 + 16)/20).

Each iteration is an iSTFT, an STFT and two small products in stock
PyTorch ops (``torch.fft``, float32 matmuls with TF32 off); the iSTFT
keeps the JAX package's normalization (Hann synthesis window, divided by
the overlap-added squared window; ``torch.istft`` normalizes otherwise).
The initial phase is the one random draw: it is injected as U(0, 1)
draws (``uniform``) or drawn from a ``torch.Generator``; the vocoder
reseeds its generator from ``seed`` on every call, so the same mels give
the same audio.
"""

from __future__ import annotations

import math
from typing import Optional, Protocol

import numpy as np
import torch

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.ops.stft import (
    exact_float32,
    frame_signal,
    mel_basis,
    mel_filterbank,
    window_tensor,
)


class Vocoder(Protocol):
    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """normalized mel [T, 80] -> waveform [N] float32 @ sample_rate."""


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., T, n_fft] -> [..., n_fft + (T-1)*hop], as JAX's scatter-free
    form (vocoder.py:39-61): block i of frame t lands at output block
    t + i, summed in the same order."""
    t, n_fft = frames.shape[-2:]
    if n_fft % hop:
        raise ValueError(f"hop {hop} must divide n_fft {n_fft}")
    nblk = n_fft // hop
    chunks = frames.reshape(*frames.shape[:-1], nblk, hop)
    out = None
    for i in range(nblk):
        part = torch.nn.functional.pad(chunks[..., i, :],
                                       (0, 0, i, nblk - 1 - i))
        out = part if out is None else out + part
    return out.reshape(*frames.shape[:-2], (t + nblk - 1) * hop)


def _window_sum(t: int, n_fft: int, hop: int, device) -> torch.Tensor:
    """The overlap-added squared window of T frames, floored at 1e-8."""
    window = window_tensor(n_fft, device)
    wsum = _overlap_add((window ** 2).expand(t, n_fft), hop)
    return torch.clamp(wsum, min=1e-8)


def _istft(spec: torch.Tensor, n_fft: int, hop: int,
           wsum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse STFT with Hann overlap-add, normalized by the squared
    window's overlap-add: [..., T, n_fft//2+1] complex ->
    [..., (T-1)*hop], center-trimmed (vocoder.py:64-78). ``wsum`` is
    :func:`_window_sum` of T frames, if the caller holds it."""
    window = window_tensor(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    t = frames.shape[-2]
    sig = _overlap_add(frames, hop)
    if wsum is None:
        wsum = _window_sum(t, n_fft, hop, spec.device)
    sig = sig / wsum
    pad = n_fft // 2
    return sig[..., pad : pad + (t - 1) * hop]


def _stft_complex(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    window = window_tensor(n_fft, x.device)
    return torch.fft.rfft(frame_signal(x, n_fft, hop) * window, n=n_fft,
                          dim=-1)


def _phase_draws(shape, device, uniform, generator) -> torch.Tensor:
    if uniform is None:
        if generator is None:
            raise ValueError("the initial phase needs its draws: pass "
                             "uniform= or generator=")
        uniform = torch.rand(shape, generator=generator,
                             device=generator.device)
    if tuple(uniform.shape) != tuple(shape):
        raise ValueError(f"uniform must be {tuple(shape)}, got "
                         f"{tuple(uniform.shape)}")
    return uniform.to(device, torch.float32)


def _with_phase(magnitude: torch.Tensor, uniform: torch.Tensor):
    phase = uniform * 2.0 * math.pi
    return magnitude * torch.exp(1j * phase)


def griffin_lim(
    magnitude: torch.Tensor,
    *,
    uniform: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    n_fft: int = 1024,
    hop: int = 256,
    n_iter: int = 60,
    momentum: float = 0.99,
) -> torch.Tensor:
    """Phase recovery from |STFT| [..., T, F] by fast Griffin-Lim
    (momentum acceleration, Perraudin et al. 2013; JAX vocoder.py:89-123):
    each iteration projects onto consistent spectra, then accelerates.
    The initial phase from ``uniform`` [..., T, F] U(0, 1) draws, or from
    ``generator``. Returns waveforms [..., (T-1)*hop]."""
    draws = _phase_draws(magnitude.shape, magnitude.device, uniform,
                         generator)
    t_frames = magnitude.shape[-2]
    wsum = _window_sum(t_frames, n_fft, hop, magnitude.device)
    spec = _with_phase(magnitude, draws)
    prev = spec
    with exact_float32():
        for _ in range(n_iter):
            x = _istft(spec, n_fft, hop, wsum)
            rebuilt = _stft_complex(x, n_fft, hop)[..., :t_frames, :]
            proj = magnitude * (rebuilt / torch.clamp(rebuilt.abs(),
                                                      min=1e-8))
            spec = proj + momentum * (proj - prev)
            prev = proj
        return _istft(prev, n_fft, hop, wsum)


def mel_consistency_project(
    spec0: torch.Tensor,
    mel_amp: torch.Tensor,
    basis: torch.Tensor,
    n_fft: int,
    hop: int,
    n_iter: int,
    momentum: float = 0.99,
) -> torch.Tensor:
    """``n_iter`` mel-consistency projections from spec0 [B, T, F]
    complex: render to a waveform, re-analyze, and re-scale the rebuilt
    magnitudes so that their mel projection matches mel_amp [B, T, M]
    (basis [F, M]), with momentum. Returns the projected spectrum
    (vocoder.py:114-156)."""
    weight = torch.clamp(basis.sum(dim=1), min=1e-8)[None, None, :]
    t_frames = mel_amp.shape[-2]
    wsum = _window_sum(t_frames, n_fft, hop, spec0.device)
    basis_t = basis.t()
    spec, prev = spec0, spec0
    with exact_float32():
        for _ in range(n_iter):
            x = _istft(spec, n_fft, hop, wsum)
            rebuilt = _stft_complex(x, n_fft, hop)[..., :t_frames, :]
            mag_r = torch.clamp(rebuilt.abs(), min=1e-8)
            mel_now = torch.clamp(mag_r @ basis, min=1e-8)
            ratio = mel_amp / mel_now
            corr = (ratio @ basis_t) / weight
            proj = mag_r * corr * (rebuilt / mag_r)
            spec = proj + momentum * (proj - prev)
            prev = proj
    return prev


def mel_griffin_lim(
    mel_amp: torch.Tensor,
    basis: torch.Tensor,
    inv_basis: torch.Tensor,
    *,
    uniform: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    n_fft: int = 1024,
    hop: int = 256,
    n_iter: int = 60,
    momentum: float = 0.99,
) -> torch.Tensor:
    """Mel-consistency-projected fast Griffin-Lim: mel_amp [B, T, M]
    linear-amplitude targets, basis [F, M], inv_basis [M, F] -> waveforms
    [B, (T-1)*hop]. The initial phase from ``uniform`` [B, T, F] U(0, 1)
    draws, or from ``generator``."""
    with exact_float32():
        mag0 = torch.clamp(mel_amp @ inv_basis, min=1e-8)
    draws = _phase_draws(mag0.shape, mag0.device, uniform, generator)
    proj = mel_consistency_project(_with_phase(mag0, draws), mel_amp, basis,
                                   n_fft, hop, n_iter, momentum)
    return _istft(proj, n_fft, hop)


def _peak_norm_pcm16(wavs: torch.Tensor,
                     n_samples: torch.Tensor) -> torch.Tensor:
    """Peak-normalize each row to 0.9 over its true samples and quantize
    to int16 on the device: [B, N] float32, [B] counts -> [B, N] int16.
    Rounds to the nearest code (half to even, as ``jnp.round``)."""
    idx = torch.arange(wavs.shape[1], device=wavs.device)[None, :]
    mask = idx < n_samples.to(wavs.device)[:, None]
    peak = (wavs.abs() * mask).amax(dim=1)
    scale = 0.9 * 32767.0 / torch.clamp(peak, min=1e-5)
    q = torch.clamp(torch.round(wavs * scale[:, None]), -32768.0, 32767.0)
    return q.to(torch.int16)


class GriffinLimVocoder:
    """Pseudo-inverse mel + Griffin-Lim synthesis (see the module
    docstring), on ``device`` (``cuda`` unless given)."""

    def __init__(
        self,
        sample_rate: int = 16000,
        n_fft: int = 1024,
        hop: int = 256,
        n_mels: int = 80,
        fmin: float = 90.0,
        fmax: float = 7600.0,
        ref_level_db: float = 16.0,
        n_iter: int = 100,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop = hop
        self.ref_level_db = ref_level_db
        self.n_iter = n_iter
        self.seed = seed
        self.basis = mel_basis(sample_rate, n_fft, n_mels, fmin, fmax,
                               self.device)  # [F, n_mels]
        # pinv [n_mels, F], clipped non-negative (the initial magnitude
        # only; the loop enforces mel consistency)
        self.inv_basis = torch.from_numpy(np.maximum(
            np.linalg.pinv(mel_filterbank(sample_rate, n_fft, n_mels, fmin,
                                          fmax)), 0.0).astype(np.float32)
        ).to(self.device)

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        return self.synthesize_batch([np.asarray(mel)])[0]

    def synthesize_batch(self, mels: list, pcm16: bool = False,
                         uniform: Optional[torch.Tensor] = None) -> list:
        """Synthesize many mels in one batch, padded to a common length
        rounded up to 32 frames (zero frames are the normalized scale's
        silence floor), each output trimmed to its (T-1)*hop samples and
        peak-normalized to 0.9. ``pcm16=True`` normalizes and quantizes
        on the device and returns int16 arrays (4x fewer bytes to fetch).
        ``uniform`` [B, T_pad, n_fft//2+1] injects the initial phase's
        draws; by default a generator on the vocoder's device, seeded from
        ``seed``, draws them."""
        t_max = -(-max(len(m) for m in mels) // 32) * 32
        batch = np.zeros((len(mels), t_max, mels[0].shape[1]), np.float32)
        for i, m in enumerate(mels):
            batch[i, : len(m)] = m
        db = torch.from_numpy(batch).to(self.device) * 100.0 - 100.0 + (
            self.ref_level_db)
        amp = torch.pow(10.0, db / 20.0)  # [B, T, 80]
        generator = None
        if uniform is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed)
        wavs = mel_griffin_lim(amp, self.basis, self.inv_basis,
                               uniform=uniform, generator=generator,
                               n_fft=self.n_fft, hop=self.hop,
                               n_iter=self.n_iter)
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
