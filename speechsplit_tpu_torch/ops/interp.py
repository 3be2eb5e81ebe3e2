"""Random time resampling, the training augmentation (counterpart of
speechsplit_tpu/ops/interp.py; reference InterpLnr, model.py:355-436).

Each sequence is cut into segments of U{min_len_seg .. max_len_seg-1}
frames, each segment is linearly resampled by its own factor
U(0.5, 1.5), the surviving frames are concatenated and the result is
zero-padded to ``max_len_pad``.

:func:`resample_fixed` is the deterministic core in the JAX package's
gather form (interp.py:110-176, 203-206): every output frame finds its
segment from the per-segment output counts, then gathers its two source
frames and interpolates. It is stock PyTorch (``gather``), and autograd
differentiates it with respect to ``x``.

:func:`random_resample` draws the segment factors and lengths itself.
The draws are small ([B, S] each) and come from a CPU
``torch.Generator`` the caller passes, as one ``torch.rand`` then one
``torch.randint`` of shape [B, S], and are then moved to ``x``'s device:
a re-seeded generator gives the same draws, and so the same output, on
the card and on the CPU. The laws are the JAX package's; the stream is
not (JAX PRNG keys cannot be reproduced in torch), so tests inject the
draws through :func:`resample_fixed` in both packages.

Placement invariance (JAX's ``example_ids``, interp.py:62-93): a rank
of a data-parallel world that holds rows ``example_ids`` of a
``global_batch``-row batch draws the whole ``[global_batch, S]`` pair,
in the same order, and keeps its rows. Every rank's generator then moves
as one process's does at the global batch, and each global row gets the
draws that process gives it; the ranks follow its trajectory up to the
order of sums.
"""

from __future__ import annotations

from typing import Optional

import torch


def resample_fixed(
    x: torch.Tensor,
    len_seq: torch.Tensor,
    scales: torch.Tensor,
    len_seg: torch.Tensor,
    *,
    max_len_pad: int,
    seg_span: int,
) -> torch.Tensor:
    """Resample ``x`` [B, T, C] with fixed draws: ``scales`` [B, S]
    (float32 factors), ``len_seg`` [B, S] (int segment lengths),
    ``len_seq`` [B] true lengths. ``seg_span`` bounds the output frames
    of one segment (``2 * max_len_seg`` covers scale 0.5). Returns
    [B, max_len_pad, C]."""
    batch, t_in, _ = x.shape
    num_seg = scales.shape[1]
    span = seg_span
    dev = x.device
    scales = scales.to(dev, torch.float32)
    len_seg = len_seg.to(dev, torch.int64)
    len_seq = len_seq.to(dev, torch.int64)

    # per-segment output counts: the valid outputs of a segment are a
    # prefix of its index range
    idx = torch.arange(span, device=dev, dtype=torch.float32)[None, None, :]
    idx_fl_all = torch.floor(idx / scales[:, :, None])  # [B, S, L]
    offset_in = torch.cumsum(len_seg, dim=1) - len_seg  # [B, S]
    valid_all = (idx_fl_all < (len_seg[:, :, None] - 1)) & (
        idx_fl_all + offset_in[:, :, None] < (len_seq[:, None, None] - 1)
    )
    counts = valid_all.sum(dim=2)  # [B, S]
    offset_out = torch.cumsum(counts, dim=1) - counts  # [B, S]

    # each output frame t: its segment, its rank inside it, its source
    t_pos = torch.arange(max_len_pad, device=dev)[None, :]  # [1, T_out]
    seg = (t_pos[:, :, None] >= offset_out[:, None, :]).sum(dim=2) - 1
    seg_c = seg.clamp(0, num_seg - 1)

    def take(a):  # [B, S] -> [B, T_out]
        return torch.gather(a, 1, seg_c)

    rank = t_pos - take(offset_out)
    idx_scaled = rank.to(torch.float32) / take(scales)
    idx_fl = torch.floor(idx_scaled)
    lam = (idx_scaled - idx_fl).to(x.dtype)[:, :, None]
    src = idx_fl.to(torch.int64) + take(offset_in)
    valid = rank < take(counts)

    src_c = src.clamp(0, t_in - 2)
    channels = x.shape[-1]
    x_fl = torch.gather(x, 1, src_c[:, :, None].expand(-1, -1, channels))
    x_cl = torch.gather(x, 1, (src_c + 1)[:, :, None].expand(-1, -1, channels))
    y = (1.0 - lam) * x_fl + lam * x_cl
    return torch.where(valid[:, :, None], y, torch.zeros_like(y))


def draw_segments(
    batch: int,
    generator: torch.Generator,
    *,
    min_len_seg: int,
    max_len_seg: int,
    max_len_seq: int,
):
    """The per-row draws of :func:`random_resample` on the CPU:
    ``(scales [B, S] ~ U(0.5, 1.5), len_seg [B, S] ~ U{min..max-1})``
    with ``S = max_len_seq // min_len_seg + 1`` (JAX interp.py:88-102)."""
    num_seg = max_len_seq // min_len_seg + 1
    scales = torch.rand(batch, num_seg, generator=generator) + 0.5
    len_seg = torch.randint(min_len_seg, max_len_seg, (batch, num_seg),
                            generator=generator)
    return scales, len_seg


def random_resample(
    x: torch.Tensor,
    len_seq: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    min_len_seg: int,
    max_len_seg: int,
    max_len_seq: int,
    max_len_pad: int,
    train: bool = True,
    example_ids: Optional[torch.Tensor] = None,
    global_batch: Optional[int] = None,
) -> torch.Tensor:
    """Randomly time-resample each row of ``x`` [B, T, C] (true lengths
    ``len_seq`` [B]) to [B, max_len_pad, C]; the identity when
    ``train`` is False. ``generator`` is a CPU ``torch.Generator``.

    ``example_ids`` [B] (int) names each row's place in a global batch
    of ``global_batch`` rows: the draws are the global batch's, and each
    row takes its own (module docstring). With ``example_ids=None`` the
    draws are ``[B, S]``."""
    if not train:
        return x
    if generator is None:
        raise ValueError(
            "random_resample in train mode needs a torch.Generator for its "
            "draws"
        )
    rows = x.shape[0]
    if example_ids is not None:
        if global_batch is None:
            raise ValueError("example_ids needs the global_batch they index")
        rows = global_batch
    scales, len_seg = draw_segments(
        rows, generator, min_len_seg=min_len_seg,
        max_len_seg=max_len_seg, max_len_seq=max_len_seq,
    )
    if example_ids is not None:
        ids = torch.as_tensor(example_ids, dtype=torch.int64, device="cpu")
        scales, len_seg = scales[ids], len_seg[ids]
    return resample_fixed(
        x, len_seq, scales, len_seg, max_len_pad=max_len_pad,
        seg_span=max_len_seg * 2,
    )
