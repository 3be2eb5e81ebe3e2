"""Kernels of the port and their plain PyTorch versions, and the names
JAX's ``ops/__init__.py`` exports."""

from speechsplit_tpu_torch.ops.interp import random_resample, resample_fixed
from speechsplit_tpu_torch.ops.quantize import (
    quantize_f0,
    quantize_f0_onehot,
    speaker_normalization,
)
from speechsplit_tpu_torch.ops.masks import (
    get_mask_from_lengths,
    pad_time_axis,
)
from speechsplit_tpu_torch.ops.stft import (
    magnitude_stft,
    mel_filterbank,
    mel_spectrogram,
)
from speechsplit_tpu_torch.ops.filters import (
    butter_highpass,
    highpass_filtfilt,
    sosfiltfilt,
    zero_phase_highpass,
)
from speechsplit_tpu_torch.ops.pitch import UNVOICED_LOG_F0, track_pitch

__all__ = [
    "random_resample",
    "resample_fixed",
    "quantize_f0",
    "quantize_f0_onehot",
    "speaker_normalization",
    "get_mask_from_lengths",
    "pad_time_axis",
    "magnitude_stft",
    "mel_filterbank",
    "mel_spectrogram",
    "butter_highpass",
    "highpass_filtfilt",
    "sosfiltfilt",
    "zero_phase_highpass",
    "track_pitch",
    "UNVOICED_LOG_F0",
]
