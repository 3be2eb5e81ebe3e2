"""F0 quantization and speaker normalization (reference: utils.py:35-74)."""

from __future__ import annotations

import torch


def quantize_f0(x: torch.Tensor, num_bins: int = 256) -> torch.Tensor:
    """Quantize normalized log-F0 in [0, 1] to integer bins.

    Unvoiced frames (``x <= 0``) map to bin 0; voiced frames to bins
    ``1 .. num_bins`` (ref: utils.py:46-58). Returns int64 ids of x's
    shape. ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    uv = x <= 0.0
    xv = torch.where(uv, torch.zeros_like(x), x)
    bins = torch.round(xv * (num_bins - 1)) + 1.0
    return torch.where(uv, torch.zeros_like(bins), bins).long()


def quantize_f0_onehot(x: torch.Tensor, num_bins: int = 256) -> torch.Tensor:
    """Quantize and one-hot: ``[...]`` -> ``[..., num_bins+1]`` float32.

    As ``jax.nn.one_hot``, an id outside ``[0, num_bins]`` (a value of
    about 1.002 or more) gives an all-zero row rather than an error.
    """
    ids = quantize_f0(x, num_bins).unsqueeze(-1)
    return (ids == torch.arange(num_bins + 1, device=x.device)).float()


def speaker_normalization(
    f0: torch.Tensor,
    voiced: torch.Tensor,
    mean_f0: torch.Tensor | float,
    std_f0: torch.Tensor | float,
) -> torch.Tensor:
    """Per-speaker normalize log-F0 to [0, 1] on voiced frames.

    ((f0 - mean)/std/4 clipped to [-1, 1] + 1) / 2 on voiced frames;
    unvoiced frames pass through unchanged (ref: utils.py:35-42).
    """
    norm = (f0 - mean_f0) / std_f0 / 4.0
    norm = torch.clamp(norm, -1.0, 1.0)
    norm = (norm + 1.0) / 2.0
    return torch.where(voiced, norm, f0)
