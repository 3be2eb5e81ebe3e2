"""Wav decoding (counterpart of speechsplit_tpu/data/prepare.py:38-76).

Only the readers the serving path needs are ported; the dataset
preparation (``extract_dir``, ``build_metadata``, ...) waits in
ROADMAP.md A6.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    """Integer PCM -> float32 in [-1, 1]; the dtype is read before any
    channel averaging (which promotes to float64 and would skip the
    scaling)."""
    if data.dtype == np.int16:
        data = data / 32768.0
    elif data.dtype == np.int32:
        data = data / 2147483648.0
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data.astype(np.float32)


def read_wav(path: str, expect_rate: int = 16000) -> np.ndarray:
    """Decode a wav file to float32 in [-1, 1] (the reference asserts
    16 kHz, make_spect_f0.py:51)."""
    rate, data = wavfile.read(path)
    if rate != expect_rate:
        raise ValueError(f"{path}: sample rate {rate} != {expect_rate}")
    return _pcm_to_float(data)


def read_wav_pcm(path: str, expect_rate: int = 16000) -> np.ndarray:
    """As :func:`read_wav`, but mono PCM16 stays int16 (the extractor
    converts it on the device); any other encoding is scaled float32."""
    rate, data = wavfile.read(path)
    if rate != expect_rate:
        raise ValueError(f"{path}: sample rate {rate} != {expect_rate}")
    if data.ndim == 1 and data.dtype == np.int16:
        return data
    return _pcm_to_float(data)
