"""Voice conversion: the 7-condition driver (counterpart of
speechsplit_tpu/convert.py; reference demo.ipynb cell-0).

The seven conditions swap subsets of {Rhythm, F0, timbre (U)} between a
source and a target utterance:

  condition   content-path input      rhythm input   speaker emb
  R           src mel + src F0        TARGET mel     src
  F           src mel + CONVERTED F0  src mel        src
  U           src mel + src F0        src mel        TARGET
  RF/RU/FU/RFU: the corresponding combinations

The converted F0 is the F0 converter's argmax over 257 bins, one-hot
again, from the source mel under the target's pitch contour.

A learned-mode generator (``spk_emb_mode="learned"``) takes its timbre
codes from mels: :func:`with_learned_embedding` replaces an utterance's
embedding by its own mel's, which makes conversion zero-shot.
"""

from __future__ import annotations

import pickle
import time
from typing import (
    Iterable,
    Iterator,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch
import torch.nn.functional as F

from speechsplit_tpu_torch import linkprobe, resolve_device
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.linkprobe import (
    Fetch,
    PinnedRing,
    finish_fetch,
    start_fetch,
)
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.ops.masks import pad_time_axis
from speechsplit_tpu_torch.ops.quantize import quantize_f0_onehot

CONDITIONS = ("R", "F", "U", "RF", "RU", "FU", "RFU")


class Utterance(NamedTuple):
    """One prepared utterance, padded to max_len_pad, on its device."""

    mel: torch.Tensor        # [1, T_pad, 80]
    f0_onehot: torch.Tensor  # [1, T_pad, 257]
    length: int
    spk_emb: torch.Tensor    # [1, 82]
    name: str = ""
    uid: str = ""


def prepare_utterance(
    config: SpeechSplitConfig,
    mel: np.ndarray,
    f0: np.ndarray,
    spk_emb: np.ndarray,
    name: str = "",
    uid: str = "",
    device=None,
) -> Utterance:
    """Pad mel/F0 and one-hot the contour (demo.ipynb cell-0 prep).

    ``device`` defaults to ``cuda`` (see :func:`resolve_device`).
    """
    dev = resolve_device(device)
    length = len(mel)
    mel_pad, _ = pad_time_axis(np.asarray(mel, np.float32)[None],
                               config.max_len_pad)
    f0_pad = np.pad(np.asarray(f0, np.float64),
                    (0, config.max_len_pad - length)).astype(np.float32)
    onehot = quantize_f0_onehot(torch.from_numpy(f0_pad), config.dim_f0 - 1)
    emb = np.asarray(spk_emb, np.float32).reshape(1, -1)
    return Utterance(
        mel=torch.from_numpy(mel_pad).to(dev),
        f0_onehot=onehot[None].to(dev),
        length=length,
        spk_emb=torch.from_numpy(emb).to(dev),
        name=name,
        uid=uid,
    )


@torch.inference_mode()
def with_learned_embedding(config: SpeechSplitConfig, g_model: SpeechSplit,
                           utt: Utterance) -> Utterance:
    """The utterance with its speaker embedding replaced by its own padded
    mel's (``g_model.embed_speaker``) when the generator was trained in
    learned mode (JAX convert.py:78-103): its decoder expects
    SpeakerEncoder embeddings, not the metadata's one-hots. A no-op in
    one-hot mode, so callers may apply it unconditionally."""
    if config.spk_emb_mode != "learned":
        return utt
    return utt._replace(spk_emb=g_model.embed_speaker(utt.mel))


@torch.inference_mode()
def _f0_onehot(p_model: F0Converter, mel_src, f0_trg_onehot) -> torch.Tensor:
    logits = p_model(mel_src, f0_trg_onehot)
    ids = torch.argmax(logits, dim=-1)
    return F.one_hot(ids, logits.shape[-1]).float()


def convert_f0(p_model: F0Converter, src: Utterance,
               trg: Utterance) -> torch.Tensor:
    """Source rhythm + target pitch -> converted one-hot contour."""
    return _f0_onehot(p_model, src.mel, trg.f0_onehot)


def _cut(condition: str, src: Utterance, trg: Utterance) -> int:
    return trg.length if "R" in condition else src.length


def _name(condition: str, src: Utterance, trg: Utterance) -> str:
    return f"{src.name}_{trg.name}_{src.uid}_{condition}"


@torch.inference_mode()
def convert(
    g_model: SpeechSplit,
    p_model: F0Converter,
    src: Utterance,
    trg: Utterance,
    conditions: Sequence[str] = CONDITIONS,
) -> List[Tuple[str, np.ndarray]]:
    """Run the conditions one forward each; returns (name, mel [T, 80])
    pairs, trimmed to the target length when rhythm was converted, else
    to the source length."""
    x_f0_org = torch.cat([src.mel, src.f0_onehot], dim=-1)
    x_f0_con = torch.cat([src.mel, convert_f0(p_model, src, trg)], dim=-1)
    results = []
    for condition in conditions:
        x_f0 = x_f0_con if "F" in condition else x_f0_org
        x_org = trg.mel if "R" in condition else src.mel
        emb = trg.spk_emb if "U" in condition else src.spk_emb
        out = g_model(x_f0, x_org, emb)
        cut = _cut(condition, src, trg)
        results.append((_name(condition, src, trg),
                        out[0, :cut].float().cpu().numpy()))
    return results


class _Submitted(NamedTuple):
    """A dispatched (pair x condition) grid: the trimmed grid on its
    device, its copy to the host (None for a probe dispatch, which is
    never fetched), and what :func:`_convert_fetch` needs to format the
    results."""

    grid: torch.Tensor
    fetch: Optional[Fetch]
    pairs: List[Tuple[Utterance, Utterance]]
    conditions: Tuple[str, ...]


def _convert_submit(
    g_model: SpeechSplit,
    p_model: F0Converter,
    pairs: Sequence[Tuple[Utterance, Utterance]],
    conditions: Sequence[str],
    compress_fetch: bool,
    start_copy: bool = True,
    ring: Optional[PinnedRing] = None,
) -> _Submitted:
    """Dispatch the (pair x condition) grid and start its copy to the
    host; nothing here waits for the device (JAX convert.py:154-230).

    On CUDA the copy runs on a copy stream into a pinned buffer of
    ``ring`` (a one-slot ring of its own when none is given), behind an
    event recorded on the compute stream. ``start_copy=False`` leaves the
    copy out: the auto-mode probe dispatches, whose compute fence must
    not share the link with a grid's copy, are never fetched."""
    with torch.inference_mode():
        mel_src = torch.cat([s.mel for s, _ in pairs], dim=0)
        mel_trg = torch.cat([t.mel for _, t in pairs], dim=0)
        f0_src = torch.cat([s.f0_onehot for s, _ in pairs], dim=0)
        f0_trg = torch.cat([t.f0_onehot for _, t in pairs], dim=0)
        emb_src = torch.cat([s.spk_emb for s, _ in pairs], dim=0)
        emb_trg = torch.cat([t.spk_emb for _, t in pairs], dim=0)

        f0_con = _f0_onehot(p_model, mel_src, f0_trg)
        x_f0_org = torch.cat([mel_src, f0_src], dim=-1)
        x_f0_con = torch.cat([mel_src, f0_con], dim=-1)

        xs, orgs, embs = [], [], []
        for condition in conditions:
            xs.append(x_f0_con if "F" in condition else x_f0_org)
            orgs.append(mel_trg if "R" in condition else mel_src)
            embs.append(emb_trg if "U" in condition else emb_src)
        out = g_model(torch.cat(xs, dim=0), torch.cat(orgs, dim=0),
                      torch.cat(embs, dim=0))  # [C * P, T, 80]

        # fetch only the frames some (pair, condition) keeps, and
        # optionally round them to bfloat16 on the device
        cut_max = max(_cut(c, s, t) for c in conditions for s, t in pairs)
        grid = out[:, :cut_max]
        if compress_fetch:
            grid = grid.to(torch.bfloat16)
        fetch = None
        if start_copy:
            fetch = start_fetch(grid, ring or PinnedRing(1))
    return _Submitted(grid, fetch, list(pairs), tuple(conditions))


def _convert_fetch(handle: _Submitted) -> List[List[Tuple[str, np.ndarray]]]:
    """Wait for one grid's copy and format the per-pair results; the
    arrays are the host's own (a bfloat16 grid widened to float32)."""
    grid = finish_fetch(handle.fetch)
    pairs, conditions = handle.pairs, handle.conditions
    results: List[List[Tuple[str, np.ndarray]]] = [[] for _ in pairs]
    for ci, condition in enumerate(conditions):
        for pi, (src, trg) in enumerate(pairs):
            row = grid[ci * len(pairs) + pi, : _cut(condition, src, trg)]
            results[pi].append((_name(condition, src, trg), row))
    return results


def convert_batched(
    g_model: SpeechSplit,
    p_model: F0Converter,
    pairs: Sequence[Tuple[Utterance, Utterance]],
    conditions: Sequence[str] = CONDITIONS,
    compress_fetch: bool = False,
) -> List[List[Tuple[str, np.ndarray]]]:
    """All conditions of all pairs in two batched forwards: one F0
    converter call over the P pairs and one generator call over the
    [C * P] (condition, pair) grid. Returns per-pair lists in
    :func:`convert`'s format.

    ``compress_fetch=True`` casts the grid to bfloat16 on the device
    before the fetch (half the bytes; about 2e-3 of rounding on the [0, 1]
    scale) and back to float32 on the host, as convert.py:209-210 does.

    For many batches in a row use :func:`convert_stream`, which overlaps
    each batch's fetch with the next batches' compute."""
    return _convert_fetch(_convert_submit(g_model, p_model, pairs,
                                          conditions, compress_fetch))


# compress_fetch="auto" decisions, keyed by _auto_key, for the life of
# the process like linkprobe's profile; linkprobe.probe_link(force=True)
# clears both (JAX convert.py:275-281)
_AUTO_DECISIONS: dict = {}


def reset_auto_decisions() -> None:
    """Drop the cached compress_fetch="auto" verdicts (after the link
    changed); ``linkprobe.probe_link(force=True)`` calls this."""
    _AUTO_DECISIONS.clear()


def _auto_key(pairs, conditions) -> tuple:
    """The key of a compress_fetch="auto" verdict: the grid's pairs and
    conditions and its fetched length ``cut_max``, since the verdict
    turns on the bytes fetched, and streams of one batch size with very
    different clip lengths must not share one (JAX convert.py:284-304)."""
    return (
        len(pairs),
        len(conditions),
        max(_cut(c, s, t) for c in conditions for s, t in pairs),
    )


def _fence(handle: _Submitted) -> None:
    """Wait until the device has computed ``handle``'s grid: an event on
    the compute stream, synchronised (JAX fetches a scalar there)."""
    if handle.grid.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(handle.grid.device))
        done.synchronize()


def convert_stream(
    g_model: SpeechSplit,
    p_model: F0Converter,
    pair_batches: Iterable[Sequence[Tuple[Utterance, Utterance]]],
    conditions: Sequence[str] = CONDITIONS,
    compress_fetch=False,
    depth: int = 2,
) -> Iterator[List[List[Tuple[str, np.ndarray]]]]:
    """Pipelined batched conversion over an iterable of pair batches
    (JAX convert.py:307-430).

    Yields one :func:`convert_batched`-format result list per batch, in
    order, while up to ``depth`` later batches compute on the card: each
    grid's copy to the host starts at its submit, on a copy stream into
    one of ``depth + 1`` pinned buffers, so it runs under its successors'
    compute and the yield rate approaches max(compute, fetch) instead of
    their sum. Each yield's arrays are the host's own; a yield keeps its
    values after later ones.

    ``compress_fetch="auto"`` chooses the mode once for a key
    (:func:`_auto_key`), before the second batch: one untimed dispatch
    of the first batch, two timed ones with their copies left out, each
    fenced on the compute stream, and the faster of the two less the
    link's RTT goes into ``linkprobe.choose_compress`` beside the link
    profile (``probe_link``). The verdict is cached in ``_AUTO_DECISIONS``
    (:func:`reset_auto_decisions`)."""
    auto = compress_fetch == "auto"
    chosen: Optional[bool] = None if auto else bool(compress_fetch)
    ring = PinnedRing(depth + 1)

    def submit(pairs, mode, start_copy=True):
        return _convert_submit(g_model, p_model, pairs, conditions, mode,
                               start_copy=start_copy, ring=ring)

    in_flight: List[_Submitted] = []
    for pairs in pair_batches:
        if chosen is None:
            key = _auto_key(pairs, conditions)
            chosen = _AUTO_DECISIONS.get(key)
        if chosen is None:
            profile = linkprobe.probe_link()
            _fence(submit(pairs, False, start_copy=False))  # warm
            compute_s = None
            for _rep in range(2):
                t0 = time.perf_counter()
                probe = submit(pairs, False, start_copy=False)
                _fence(probe)
                rep_s = time.perf_counter() - t0
                compute_s = rep_s if compute_s is None else min(compute_s,
                                                                 rep_s)
            compute_s = max(compute_s - profile.rtt_ms * 1e-3, 1e-4)
            chosen = linkprobe.choose_compress(probe.grid.numel() * 4,
                                               compute_s, profile)
            _AUTO_DECISIONS[key] = chosen
        in_flight.append(submit(pairs, chosen))
        if len(in_flight) > depth:
            yield _convert_fetch(in_flight.pop(0))
    while in_flight:
        yield _convert_fetch(in_flight.pop(0))


def convert_long(
    config: SpeechSplitConfig,
    g_model: SpeechSplit,
    p_model: F0Converter,
    src_mel: np.ndarray,
    src_f0: np.ndarray,
    src_emb: np.ndarray,
    trg_mel: np.ndarray,
    trg_f0: np.ndarray,
    trg_emb: np.ndarray,
    condition: str = "RFU",
    overlap: int = 24,
) -> np.ndarray:
    """Convert utterances longer than the model's ``max_len_pad`` frames
    (convert.py:433-520): overlapping windows at proportional positions
    on the source and target timelines (so rhythm windows correspond),
    every window pair in one ``convert_batched`` call, the outputs
    cross-faded linearly on the overlaps. Runs on the models' device.
    Returns the converted mel on the rhythm source's timeline
    ([len(trg)] if 'R' in condition else [len(src)], 80)."""
    device = next(g_model.parameters()).device
    win = config.max_len_pad
    drive_len = len(trg_mel) if "R" in condition else len(src_mel)

    def prepare(mel, f0, emb):
        return prepare_utterance(config, mel, f0, emb, device=device)

    if drive_len <= win:
        pair = (prepare(src_mel[:win], src_f0[:win], src_emb),
                prepare(trg_mel[:win], trg_f0[:win], trg_emb))
        return convert_batched(g_model, p_model, [pair], (condition,))[0][0][1]

    step = win - overlap
    n_windows = max(1, -(-(drive_len - overlap) // step))
    pairs, spans = [], []
    for i in range(n_windows):
        start = min(i * step, drive_len - win)

        def window(mel, f0):
            # the same relative position on each timeline
            length = len(mel)
            if length <= win:
                return mel, f0
            w_start = int(round(start / drive_len * (length - win)))
            return mel[w_start : w_start + win], f0[w_start : w_start + win]

        pairs.append((prepare(*window(src_mel, src_f0), src_emb),
                      prepare(*window(trg_mel, trg_f0), trg_emb)))
        spans.append(start)

    results = convert_batched(g_model, p_model, pairs, (condition,))
    out = np.zeros((drive_len, config.dim_freq), np.float32)
    weight = np.zeros((drive_len, 1), np.float32)
    fade = np.linspace(0.0, 1.0, overlap, dtype=np.float32)[:, None]
    for wi, (start, res) in enumerate(zip(spans, results)):
        mel = res[0][1]
        w = np.ones((len(mel), 1), np.float32)
        if overlap > 0 and wi > 0:
            w[:overlap] = fade  # fade in (has a predecessor)
        if overlap > 0 and wi < len(spans) - 1:
            w[-overlap:] = fade[::-1]  # fade out (has a successor)
        out[start : start + len(mel)] += mel * w
        weight[start : start + len(mel)] += w
    return out / np.maximum(weight, 1e-6)


def load_demo_metadata(path: str) -> list:
    """Load a demo.pkl-style bundle (entries: [spk_name, spk_emb(1,82),
    (mel, f0, len, uid)]). Unpickling runs code: load only files this
    project or the reference wrote."""
    with open(path, "rb") as handle:
        return pickle.load(handle)


def utterance_from_metadata(config: SpeechSplitConfig, entry: list,
                            device=None) -> Utterance:
    mel, f0, length, uid = entry[2]
    return prepare_utterance(
        config,
        np.asarray(mel)[:length],
        np.asarray(f0)[:length],
        np.asarray(entry[1]),
        name=entry[0],
        uid=uid,
        device=device,
    )
