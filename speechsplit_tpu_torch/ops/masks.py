"""Length-mask and padding utilities (reference: utils.py:78-87)."""

from __future__ import annotations

import numpy as np
import torch


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean padding mask: True at padded positions (ref: utils.py:78-81)."""
    ids = torch.arange(max_len, device=lengths.device)
    return ids[None, :] >= lengths[:, None]


def pad_time_axis(x: np.ndarray, len_out: int) -> tuple[np.ndarray, int]:
    """Right-pad ``[B, T, C]`` to ``[B, len_out, C]`` (ref: utils.py:85-87)."""
    len_pad = len_out - x.shape[1]
    if len_pad < 0:
        raise ValueError(f"sequence longer than pad target: {x.shape[1]}")
    return np.pad(x, ((0, 0), (0, len_pad), (0, 0)), "constant"), len_pad
