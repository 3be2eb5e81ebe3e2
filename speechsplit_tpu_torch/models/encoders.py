"""The bottleneck encoders (counterpart of speechsplit_tpu/models/encoders.py).

Each encoder has ``pre`` (the conv stack before its recurrence, with
the random-resampling augmentation of training) and ``codes`` (the
stride sampling after it); the generators run the recurrences between
them, every independent one in one ``ops.multi_bilstm`` launch.

In train mode ``pre`` resamples after every conv (F0Encoder) or every
conv pair (ContentPitchEncoder, content and pitch jointly so they stay
aligned), with the full padded length as every row's length
(reference model.py:105,125-129,194-211). The draws come from the
``torch.Generator`` the caller passes (see ``ops.interp``); a rank of a
data-parallel world passes its rows' ``example_ids`` and the
``global_batch`` (JAX encoders.py:124-156).

Submodule names follow the reference (Encoder_t model.py:46-89,
Encoder_6 model.py:93-140, Encoder_7 model.py:144-229) so that its
state-dict keys load unchanged. ``SpeakerEncoder`` (learned speaker
mode) has no reference counterpart and keeps the JAX module's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from speechsplit_tpu_torch.config import SpeechSplitConfig, resolve_dtype
from speechsplit_tpu_torch.models.layers import (
    LSTM,
    Conv1d,
    Linear,
    conv_norm,
    downsample_codes,
)
from speechsplit_tpu_torch.ops.interp import random_resample


def _resample(config: SpeechSplitConfig, x: torch.Tensor,
              generator: torch.Generator, example_ids=None,
              global_batch=None) -> torch.Tensor:
    """One train-mode resample of x [B, T, C] at full padded length;
    ``example_ids``/``global_batch`` as ``ops.interp.random_resample``
    takes them."""
    full_len = torch.full((x.shape[0],), config.max_len_pad,
                          dtype=torch.int64)
    return random_resample(
        x, full_len, generator,
        min_len_seg=config.min_len_seg, max_len_seg=config.max_len_seg,
        max_len_seq=config.max_len_seq, max_len_pad=config.max_len_pad,
        example_ids=example_ids, global_batch=global_batch,
    )


class _DropsLenOrg(nn.Module):
    """The reference registers a constant ``len_org`` buffer (=
    max_len_pad, model.py:105,157) in Encoder_6/Encoder_7; it carries no
    learned state, and is dropped on load so strict loading of a
    reference checkpoint succeeds."""

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "len_org", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class RhythmEncoder(nn.Module):
    """conv(dim_freq -> dim_enc_2, k5) + GroupNorm + ReLU, BiLSTM(dim_neck_2),
    stride-freq_2 code sampling -> [B, T/freq_2, 2*dim_neck_2]."""

    def __init__(self, config: SpeechSplitConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.convolutions = nn.ModuleList([
            conv_norm(cfg.dim_freq, cfg.dim_enc_2,
                      cfg.dim_enc_2 // cfg.chs_grp, generator, dtype)
        ])
        self.lstm = LSTM(cfg.dim_enc_2, cfg.dim_neck_2, 1, generator,
                         dtype=dtype,
                         residual_dtype=resolve_dtype(cfg.residual_dtype))

    def pre(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.convolutions[0](x))

    def codes(self, outputs: torch.Tensor) -> torch.Tensor:
        return downsample_codes(outputs, self.config.dim_neck_2,
                                self.config.freq_2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder on its own (``SpeechSplit.rhythm``)."""
        return self.codes(self.lstm(self.pre(x)))


class F0Encoder(_DropsLenOrg):
    """3 x [conv(dim_f0 -> dim_enc_3, k5) + GroupNorm + ReLU, and in
    train mode a random resample], BiLSTM(dim_neck_3), stride-freq_3
    sampling."""

    def __init__(self, config: SpeechSplitConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        groups = cfg.dim_enc_3 // cfg.chs_grp
        self.convolutions = nn.ModuleList([
            conv_norm(cfg.dim_f0 if i == 0 else cfg.dim_enc_3, cfg.dim_enc_3,
                      groups, generator, dtype)
            for i in range(3)
        ])
        self.lstm = LSTM(cfg.dim_enc_3, cfg.dim_neck_3, 1, generator,
                         dtype=dtype,
                         residual_dtype=resolve_dtype(cfg.residual_dtype))

    def pre(self, x: torch.Tensor, train: bool = False,
            generator: torch.Generator | None = None, example_ids=None,
            global_batch=None) -> torch.Tensor:
        for conv in self.convolutions:
            x = F.relu(conv(x))
            if train:
                x = _resample(self.config, x, generator, example_ids,
                              global_batch)
        return x

    def codes(self, outputs: torch.Tensor) -> torch.Tensor:
        return downsample_codes(outputs, self.config.dim_neck_3,
                                self.config.freq_3)


class ContentPitchEncoder(_DropsLenOrg):
    """Two conv stacks (mel -> dim_enc, one-hot F0 -> dim_enc_3); content
    through a 2-layer BiLSTM(dim_neck), pitch through a 1-layer
    BiLSTM(dim_neck_3). Input [B, T, dim_freq + dim_f0]; returns
    ``(codes_content [B, T/freq, 2*dim_neck],
       codes_pitch [B, T/freq_3, 2*dim_neck_3])``."""

    def __init__(self, config: SpeechSplitConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.convolutions_1 = nn.ModuleList([
            conv_norm(cfg.dim_freq if i == 0 else cfg.dim_enc, cfg.dim_enc,
                      cfg.dim_enc // cfg.chs_grp, generator, dtype)
            for i in range(3)
        ])
        self.convolutions_2 = nn.ModuleList([
            conv_norm(cfg.dim_f0 if i == 0 else cfg.dim_enc_3, cfg.dim_enc_3,
                      cfg.dim_enc_3 // cfg.chs_grp, generator, dtype)
            for i in range(3)
        ])
        self.lstm_1 = LSTM(cfg.dim_enc, cfg.dim_neck, 2, generator,
                           dtype=dtype,
                           residual_dtype=resolve_dtype(cfg.residual_dtype))
        self.lstm_2 = LSTM(cfg.dim_enc_3, cfg.dim_neck_3, 1, generator,
                           dtype=dtype,
                           residual_dtype=resolve_dtype(cfg.residual_dtype))

    def pre(self, x_f0: torch.Tensor, train: bool = False,
            generator: torch.Generator | None = None, example_ids=None,
            global_batch=None):
        """Conv stacks (with the joint resamples in train mode); returns
        the (content, pitch) streams."""
        cfg = self.config
        x = x_f0[:, :, : cfg.dim_freq]
        f0 = x_f0[:, :, cfg.dim_freq :]
        for conv_mel, conv_f0 in zip(self.convolutions_1,
                                     self.convolutions_2):
            x = F.relu(conv_mel(x))
            f0 = F.relu(conv_f0(f0))
            if train:
                joint = _resample(cfg, torch.cat([x, f0], dim=-1), generator,
                                  example_ids, global_batch)
                x = joint[:, :, : cfg.dim_enc]
                f0 = joint[:, :, cfg.dim_enc :]
        return x, f0

    def codes(self, content: torch.Tensor, pitch: torch.Tensor):
        cfg = self.config
        return (
            downsample_codes(content, cfg.dim_neck, cfg.freq),
            downsample_codes(pitch, cfg.dim_neck_3, cfg.freq_3),
        )


class SpeakerEncoder(nn.Module):
    """Utterance -> unit-norm speaker embedding [B, dim_spk_emb] (JAX
    encoders.py:273-355), the timbre code of ``spk_emb_mode="learned"``.

    Three k5 convs at ``dim_spk_enc`` channels, each followed by group
    statistics over the valid frames only (energy mask ``max(mel) > 0``
    over the mel bins: the collator zeroes frames past a crop's length),
    ``scale_i``/``bias_i``, a ReLU and the mask again; then float32 mean
    and std pooling over the valid frames (std floored at sqrt(1e-8)), a
    ``Linear`` and L2 normalization. The masked statistics make the
    embedding exactly invariant to trailing zero padding, which
    ``torch.nn.GroupNorm`` (over the whole padded window) would not be.
    No recurrence: its work runs in stock PyTorch ops (cuDNN convs and
    cuBLAS products). At bfloat16 ``dtype`` the convs and the
    ``Linear`` round as ``models.layers`` does; the statistics stay
    float32.
    """

    def __init__(self, config: SpeechSplitConfig, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.groups = cfg.dim_spk_enc // cfg.chs_grp
        for i in range(3):
            setattr(self, f"conv_{i}", Conv1d(
                cfg.dim_freq if i == 0 else cfg.dim_spk_enc, cfg.dim_spk_enc,
                generator, kernel_size=5, w_init_gain="relu", dtype=dtype))
            setattr(self, f"scale_{i}",
                    nn.Parameter(torch.ones(cfg.dim_spk_enc)))
            setattr(self, f"bias_{i}",
                    nn.Parameter(torch.zeros(cfg.dim_spk_enc)))
        self.proj = Linear(2 * cfg.dim_spk_enc, cfg.dim_spk_emb, generator,
                           dtype=dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        mask = (mel.float().amax(dim=-1, keepdim=True) > 0.0).float()
        frames = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        h = mel
        for i in range(3):
            h = getattr(self, f"conv_{i}")(h)
            b, t, c = h.shape
            hg = h.float().reshape(b, t, self.groups, -1)
            m = mask[..., None]
            denom = frames[..., None] * hg.shape[-1]
            mean = (hg * m).sum(dim=(1, 3), keepdim=True) / denom
            var = ((hg - mean).square() * m).sum(dim=(1, 3),
                                                 keepdim=True) / denom
            hg = (hg - mean) * torch.rsqrt(var + 1e-5) * m
            h = F.relu((hg.reshape(b, t, c) * getattr(self, f"scale_{i}")
                        + getattr(self, f"bias_{i}")) * mask)
        h = h.float()
        mean = (h * mask).sum(dim=1) / frames[:, 0]
        var = ((h - mean[:, None, :]).square() * mask).sum(dim=1) / (
            frames[:, 0])
        stats = torch.cat([mean, torch.sqrt(torch.clamp(var, min=1e-8))],
                          dim=-1)
        emb = self.proj(stats).float()
        return emb * torch.rsqrt(emb.square().sum(dim=-1, keepdim=True)
                                 + 1e-8)
