"""Batched feature extraction: wav -> (mel, normalized log-F0) on the card
(counterpart of speechsplit_tpu/preprocess.py; reference
make_spect_f0.py).

  reference (per file, host):            here (per batch, device):
    scipy filtfilt high-pass               the high-pass on STFT bins, or
                                           an FFT zero-phase high-pass
    *0.96 + seeded dither                  *0.96 + injected dither draws
    pySTFT -> mel -> dB -> [0,1]           ops.stft.mel_spectrogram
    pysptk RAPT -> log-F0                  ops.pitch.track_pitch
    per-utterance mean/std norm            masked mean/std on device

Speaker gender selects the F0 search range (M: 50-250 Hz, F: 100-600 Hz,
make_spect_f0.py:40-45). Mel and F0 both have N // hop + 1 frames.

The dither noise is the one random draw: :func:`extract_features` takes
its U(0, 1) draws as a ``uniform`` [B, N] tensor or draws them from a
``torch.Generator`` the caller passes, on that generator's device (JAX
PRNG streams cannot be reproduced in torch, so the tests inject JAX's
draws). :func:`extract_features_scan` runs K same-shape batches, the
call ``data.prepare.extract_dir`` makes; :func:`extract_into_store`
writes K batches' features straight into a device-resident store
(``data.resident.build_resident_from_wavs``); both take
:func:`extract_features`'s keywords (the front end's options, such as
``highpass_mode`` and ``pitch_params``), as JAX's do.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.ops.filters import (
    butter_highpass,
    zero_phase_highpass,
)
from speechsplit_tpu_torch.ops.pitch import (
    UNVOICED_LOG_F0,
    PitchParams,
    track_pitch,
)
from speechsplit_tpu_torch.ops.stft import mel_spectrogram

GENDER_F0_RANGE = {"M": (50.0, 250.0), "F": (100.0, 600.0)}


@functools.lru_cache(maxsize=8)
def _stft_bin_gain(cutoff: float, fs: float, order: int,
                   n_fft: int) -> np.ndarray:
    """|H(w)|^2 of the zero-phase high-pass at STFT bin frequencies."""
    from scipy import signal as sp_signal

    b, a = butter_highpass(cutoff, fs, order)
    freqs = np.fft.rfftfreq(n_fft) * 2.0 * np.pi
    _, h = sp_signal.freqz(b, a, worN=freqs)
    return (h * np.conj(h)).real.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _bin_gain_tensor(cutoff: float, fs: float, order: int, n_fft: int,
                     device: torch.device) -> torch.Tensor:
    """:func:`_stft_bin_gain` on ``device``, uploaded once a process (a
    pageable upload on every call would wait for the card each time)."""
    return torch.from_numpy(_stft_bin_gain(cutoff, fs, order, n_fft)).to(
        device)


def _as_tensor(x, device, dtype=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def extract_features(
    wavs,
    lengths,
    f0_lo,
    f0_hi,
    *,
    uniform: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    sample_rate: int = 16000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 80,
    fmin: float = 90.0,
    fmax: float = 7600.0,
    cutoff: float = 30.0,
    order: int = 5,
    dither: float = 1e-6,
    gain: float = 0.96,
    highpass_mode: str = "stft",
    pitch_params: Optional[PitchParams] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass over a padded batch of waveforms (preprocess.py:56-175).

    Args:
      wavs: [B, N] float32 in [-1, 1] or int16 PCM, zero-padded (numpy
        or a tensor); int16 converts on the device, exactly.
      lengths: [B] true sample counts. f0_lo, f0_hi: [B] pitch search
        bounds (Hz).
      uniform: [B, N] U(0, 1) draws for the dither; else ``generator``
        draws them on its own device. One of the two is needed.
      device: ``cuda`` unless given (see ``resolve_device``).
      highpass_mode: how the 30 Hz zero-phase high-pass is realized
        (preprocess.py:85-94): "stft", the filter's |H|^2 on the STFT
        bins before the mel projection (the production path); "time",
        :func:`ops.filters.zero_phase_highpass` on the waveform before
        the gain and dither, with no bin gain.

    Returns:
      mel [B, T, n_mels] in [0, 1] (frames past an utterance's end are
      garbage: cut with ``frame_count``) and f0_norm [B, T]: the
      speaker-normalized log-F0 in [0, 1], -1e10 at unvoiced frames.
    """
    if highpass_mode not in ("stft", "time"):
        raise ValueError(highpass_mode)
    dev = resolve_device(device)
    wavs = _as_tensor(wavs, dev)
    if wavs.dtype == torch.int16:
        # every int16 / 32768 is exact in float32
        wavs = wavs.to(torch.float32) / 32768.0
    wavs = wavs.to(torch.float32)
    lengths = _as_tensor(lengths, dev, torch.int64)
    f0_lo = _as_tensor(f0_lo, dev, torch.float32)
    f0_hi = _as_tensor(f0_hi, dev, torch.float32)
    if uniform is None:
        if generator is None:
            raise ValueError("extract_features needs the dither's draws: "
                             "pass uniform= or generator=")
        uniform = torch.rand(wavs.shape, generator=generator,
                             device=generator.device)
    uniform = uniform.to(dev, torch.float32)
    if uniform.shape != wavs.shape:
        raise ValueError(f"uniform must be {tuple(wavs.shape)}, got "
                         f"{tuple(uniform.shape)}")

    # gain + dither (make_spect_f0.py:55); the high-pass per mode
    noise = (uniform - 0.5) * 2.0 * dither
    if highpass_mode == "time":
        y = zero_phase_highpass(wavs, lengths, cutoff=cutoff,
                                fs=float(sample_rate), order=order)
        y = y * gain + noise
        bin_gain = None
    else:
        y = wavs * gain + noise
        bin_gain = _bin_gain_tensor(cutoff, float(sample_rate), order,
                                    n_fft, dev)

    mel = mel_spectrogram(y, sample_rate=sample_rate, n_fft=n_fft, hop=hop,
                          n_mels=n_mels, fmin=fmin, fmax=fmax,
                          bin_gain=bin_gain)
    logf0 = track_pitch(y, lengths, f0_lo, f0_hi, sample_rate=sample_rate,
                        hop=hop, params=pitch_params or PitchParams())

    return mel, normalize_log_f0(logf0)


def extract_features_scan(
    wavs,
    lengths,
    f0_lo,
    f0_hi,
    *,
    uniform=None,
    generator: Optional[torch.Generator] = None,
    compress: bool = False,
    device=None,
    **static,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K same-shape batches of :func:`extract_features`
    (preprocess.py:189-246): wavs [K, B, N], lengths, f0_lo, f0_hi
    [K, B] -> (mel [K, B, T, M], f0 [K, B, T]). ``static`` takes
    :func:`extract_features`'s keywords (``sample_rate`` ... ``gain``,
    ``highpass_mode``, ``pitch_params``), as JAX's ``**static``.

    JAX scans the K batches inside one compiled program; here they are K
    calls, each batch's features those of :func:`extract_features` on it.
    ``uniform[k]`` holds batch k's [B, N] draws (a [K, B, N] tensor or a
    sequence of K); else ``generator`` draws them batch after batch.
    ``compress=True`` returns both in bfloat16, the unvoiced sentinel the
    bfloat16 nearest -1e10 as in JAX (:224-229)."""
    out_mel, out_f0 = [], []
    for k in range(len(wavs)):
        mel, f0 = extract_features(
            wavs[k], lengths[k], f0_lo[k], f0_hi[k],
            uniform=None if uniform is None else uniform[k],
            generator=generator, device=device, **static)
        if compress:
            sentinel = torch.full((), UNVOICED_LOG_F0, dtype=torch.bfloat16,
                                  device=f0.device)
            f0 = torch.where(f0 < -1e9, sentinel, f0.to(torch.bfloat16))
            mel = mel.to(torch.bfloat16)
        out_mel.append(mel)
        out_f0.append(f0)
    return torch.stack(out_mel), torch.stack(out_f0)


def extract_into_store(
    mel_store: torch.Tensor,
    f0_store: torch.Tensor,
    wavs,
    lengths,
    f0_lo,
    f0_hi,
    uids,
    *,
    uniform=None,
    generator: Optional[torch.Generator] = None,
    **static,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K same-shape batches extracted and written in place into a
    device-resident feature store (preprocess.py:249-310): the features
    never leave the device.

    Each batch is :func:`extract_features` on it (the draws as
    :func:`extract_features_scan` takes them), each row masked past its
    ``frame_count`` (mel 0, F0 ``UNVOICED_LOG_F0``, the padding
    ``data.resident.build_resident`` gives), cast to the store's dtype
    and written at ``[uid, :T_batch]``.

    Args:
      mel_store: [U, T_pad, n_mels] store (float32 or bfloat16), written
        in place. f0_store: [U, T_pad], likewise.
      wavs, lengths, f0_lo, f0_hi: [K, B, N] and [K, B] host arrays, as
        :func:`extract_features_scan`'s.
      uids: [K, B] host row ids into the store. JAX drops rows at
        ``uid >= U`` (the repeats that fill a short group); the port's
        groups hold no repeats, so a row out of range raises.
      static: :func:`extract_features`'s keywords (``hop``,
        ``highpass_mode``, ``pitch_params``, ...), as JAX's ``**static``.

    Returns (mel_store, f0_store).
    """
    hop = static.get("hop", 256)
    uids = np.asarray(uids)
    u, t_pad = f0_store.shape
    if uids.size and (uids.min() < 0 or uids.max() >= u):
        raise ValueError(f"uids must lie in [0, {u}), got "
                         f"{uids.min()}..{uids.max()}")
    dev = f0_store.device
    rows = torch.from_numpy(uids.astype(np.int64))
    if dev.type == "cuda":  # a pageable upload would wait for the card
        rows = rows.pin_memory().to(dev, non_blocking=True)
    for k in range(len(wavs)):
        mel, f0 = extract_features(
            wavs[k], lengths[k], f0_lo[k], f0_hi[k],
            uniform=None if uniform is None else uniform[k],
            generator=generator, device=dev, **static)
        t = mel.shape[1]
        if t > t_pad:
            raise ValueError(f"a batch of {t} frames does not fit a store "
                             f"of {t_pad}")
        frames = _as_tensor(lengths[k], dev, torch.int64) // hop + 1
        keep = torch.arange(t, device=dev)[None, :] < frames[:, None]
        mel_store[rows[k], :t] = torch.where(
            keep[..., None], mel, 0.0).to(mel_store.dtype)
        f0_store[rows[k], :t] = torch.where(
            keep, f0, UNVOICED_LOG_F0).to(f0_store.dtype)
    return mel_store, f0_store


def normalize_log_f0(logf0: torch.Tensor) -> torch.Tensor:
    """Per-utterance speaker normalization over the voiced frames of
    logf0 [B, T] (preprocess.py:159-173; reference utils.py:35-42):
    ((f0 - mean) / std / 4 clipped to [-1, 1] + 1) / 2, -1e10 kept at
    unvoiced frames."""
    voiced = logf0 > -1e9
    zero = torch.zeros((), device=logf0.device)
    count = voiced.sum(dim=1, keepdim=True).clamp(min=1)
    mean = torch.where(voiced, logf0, zero).sum(dim=1, keepdim=True) / count
    var = torch.where(voiced, torch.square(logf0 - mean), zero).sum(
        dim=1, keepdim=True) / count
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    norm = torch.clamp((logf0 - mean) / std / 4.0, -1.0, 1.0)
    norm = (norm + 1.0) / 2.0
    return torch.where(voiced, norm,
                       torch.full((), UNVOICED_LOG_F0, device=logf0.device))


def frame_count(length: int, hop: int = 256) -> int:
    """Frames produced for a signal of ``length`` samples."""
    return length // hop + 1


def pad_batch(wavs: list, bucket: int = 32768) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Zero-pad 1-D waveforms to a common length, rounded up to a
    multiple of ``bucket`` (preprocess.py:322-353); returns (batch,
    lengths). An all-int16 batch stays int16 (the extractor converts on
    the device); a mixed one is float32 with its PCM16 rows scaled."""
    lengths = np.array([len(w) for w in wavs], np.int32)
    n = int(lengths.max())
    n = ((n + bucket - 1) // bucket) * bucket
    dtype = np.int16 if all(w.dtype == np.int16 for w in wavs) else (
        np.float32)
    out = np.zeros((len(wavs), n), dtype)
    for i, w in enumerate(wavs):
        if dtype == np.float32 and w.dtype == np.int16:
            out[i, : len(w)] = w / np.float32(32768.0)
        else:
            out[i, : len(w)] = w
    return out, lengths
