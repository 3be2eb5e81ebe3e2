"""STFT and mel front end (counterpart of speechsplit_tpu/ops/stft.py;
reference make_spect_f0.py:15-16,58-61 and utils.py:18-31).

Reflect-padded magnitude STFT (1024-point FFT, hop 256, periodic Hann),
a Slaney-scale mel filterbank (80 bins, 90-7600 Hz),
``20*log10(max(1e-5, .)) - 16`` dB compression, then ``(dB+100)/100``
into [0, 1], batched over utterances.

The window and the filterbank are numpy copies of the JAX package's.
Framing is ``Tensor.unfold`` over the reflect-padded signal, which gives
the windows of JAX's ``strided_windows``; the FFTs are ``torch.fft``.
The mel projection is one float32 product whatever the global TF32
switches say (:func:`exact_float32`).
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_float32():
    """Full float32 in cuBLAS matmuls and cuDNN convolutions while the
    block runs (TF32 off), the caller's switches restored after it: the
    front end and the vocoder compute in float32 as the JAX package does,
    also inside a block that turned TF32 on (``training.matmul_precision``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', n, fftbins=True)``)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32
    )


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney auditory-toolbox mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    mels = f / f_sp
    above = f >= min_log_hz
    return np.where(
        above,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    freqs = m * f_sp
    above = m >= min_log_mel
    return np.where(
        above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs
    )


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sample_rate: int = 16000,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 90.0,
    fmax: float = 7600.0,
) -> np.ndarray:
    """Triangular mel filterbank, Slaney scale and Slaney area
    normalization, ``[n_fft//2 + 1, n_mels]`` float32 (already transposed
    for a frames @ basis product). Cached: do not write into it."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(
            _hz_to_mel_slaney(np.array(fmin))[()],
            _hz_to_mel_slaney(np.array(fmax))[()],
            n_mels + 2,
        )
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]  # [n_mels+2, F]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # [n_mels, F]
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)  # [F, n_mels]


@functools.lru_cache(maxsize=16)
def _device_array(name: str, args: tuple, device: torch.device) -> torch.Tensor:
    """A cached copy on ``device`` of ``hann_window(*args)`` or
    ``mel_filterbank(*args)``: one upload a process, not one a call."""
    array = {"hann": hann_window, "mel": mel_filterbank}[name](*args)
    return torch.from_numpy(np.array(array)).to(device)


def window_tensor(n_fft: int, device) -> torch.Tensor:
    return _device_array("hann", (n_fft,), torch.device(device))


def mel_basis(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
              fmax: float, device) -> torch.Tensor:
    return _device_array("mel", (sample_rate, n_fft, n_mels, fmin, fmax),
                         torch.device(device))


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Reflect-pad by n_fft//2 and cut into overlapping frames:
    x [..., N] -> [..., N // hop + 1, n_fft] (utils.py:20-26)."""
    pad = n_fft // 2
    lead = x.shape[:-1]
    padded = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    padded = padded.reshape(*lead, padded.shape[-1])
    n_frames = (padded.shape[-1] - (n_fft - hop)) // hop
    return padded.unfold(-1, n_fft, hop)[..., :n_frames, :]


def magnitude_stft(x: torch.Tensor, n_fft: int = 1024,
                   hop: int = 256) -> torch.Tensor:
    """|STFT| of [..., N] -> [..., n_frames, n_fft//2+1]."""
    frames = frame_signal(x, n_fft, hop)
    window = window_tensor(n_fft, x.device)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs()


def mel_spectrogram(
    x: torch.Tensor,
    *,
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 80,
    fmin: float = 90.0,
    fmax: float = 7600.0,
    ref_level_db: float = 16.0,
    bin_gain: torch.Tensor | None = None,
) -> torch.Tensor:
    """wav [..., N] -> normalized mel [..., T, n_mels] in [0, 1]
    (make_spect_f0.py:58-61). ``bin_gain`` [n_fft//2+1] multiplies each
    STFT bin before the projection (the spectral high-pass of
    ``preprocess.extract_features``)."""
    spec = magnitude_stft(x, n_fft, hop)
    basis = mel_basis(sample_rate, n_fft, n_mels, fmin, fmax, x.device)
    if bin_gain is not None:
        basis = bin_gain[:, None] * basis
    with exact_float32():
        mel = spec @ basis
    min_level = math.exp(-100.0 / 20.0 * math.log(10.0))
    db = 20.0 * torch.log10(torch.clamp(mel, min=min_level)) - ref_level_db
    return (db + 100.0) / 100.0
