"""Models of the port; all sequence tensors are ``[B, T, C]``."""

from speechsplit_tpu_torch.models.layers import LSTM, Conv1d, GroupNorm, Linear
from speechsplit_tpu_torch.models.encoders import (
    ContentPitchEncoder,
    F0Encoder,
    RhythmEncoder,
    SpeakerEncoder,
)
from speechsplit_tpu_torch.models.decoders import F0Decoder, MelDecoder
from speechsplit_tpu_torch.models.generator import F0Converter, SpeechSplit

__all__ = [
    "LSTM",
    "Conv1d",
    "GroupNorm",
    "Linear",
    "RhythmEncoder",
    "F0Encoder",
    "ContentPitchEncoder",
    "SpeakerEncoder",
    "MelDecoder",
    "F0Decoder",
    "SpeechSplit",
    "F0Converter",
]
