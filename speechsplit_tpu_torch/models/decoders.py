"""Decoders (counterpart of speechsplit_tpu/models/decoders.py).

Reference: Decoder_3 model.py:233-255, Decoder_4 model.py:259-279; the
submodule names ``lstm`` and ``linear_projection`` are the reference's.
"""

from __future__ import annotations

import torch
from torch import nn

from speechsplit_tpu_torch.config import SpeechSplitConfig, resolve_dtype
from speechsplit_tpu_torch.models.layers import LSTM, Linear


class MelDecoder(nn.Module):
    """3-layer BiLSTM(dim_dec_mel) + linear projection to mel bins; input
    [content, rhythm, pitch, speaker] (164 wide at defaults)."""

    def __init__(self, config: SpeechSplitConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.lstm = LSTM(cfg.dim_code, cfg.dim_dec_mel, 3, generator,
                         dtype=dtype,
                         residual_dtype=resolve_dtype(cfg.residual_dtype))
        self.linear_projection = Linear(2 * cfg.dim_dec_mel, cfg.dim_freq,
                                        generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_projection(self.lstm(x))


class F0Decoder(nn.Module):
    """2-layer BiLSTM(dim_dec_f0) + linear projection to quantized-F0
    logits; input [rhythm, pitch] (66 wide at defaults)."""

    def __init__(self, config: SpeechSplitConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.lstm = LSTM(2 * cfg.dim_neck_2 + 2 * cfg.dim_neck_3,
                         cfg.dim_dec_f0, 2, generator, dtype=dtype,
                         residual_dtype=resolve_dtype(cfg.residual_dtype))
        self.linear_projection = Linear(2 * cfg.dim_dec_f0, cfg.dim_f0,
                                        generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_projection(self.lstm(x))
