"""Device-resident training data (counterpart of
speechsplit_tpu/data/resident.py): the corpus's features live on the
card, the crops are gathered there, and the host sends only index
vectors a step.

A host-loader step uploads its collated batch (about 1 MB at B16:
mel, F0 and embeddings) and collates it in numpy first. Here every
utterance is uploaded once (:func:`build_resident`, or extracted on the
card straight into the store by :func:`build_resident_from_wavs`), and a
step's batch is three ``[B]`` int32 vectors (utterance, crop length,
crop offset: a :class:`Plan`) that :func:`collate_on_device` turns into
the collated ``Batch`` with one gather and a mask.

Parity: :func:`plan_batches` replays the host loader's draws (the
sampler's epoch, each speaker's utterance pick, each crop's length and
offset, from one ``np.random.default_rng(seed)``, data/loader.py), so
for a seed the resident batches equal ``data_loader``'s bit for bit
(and JAX's ``collate_on_device``'s).

Memory: a float32 store costs ``T_pad * (dim_freq + 1) * 4`` bytes an
utterance (plus ``4 * (dim_spk_emb + 1)`` for its embedding and length),
``T_pad`` being the longest utterance's frames plus ``max_len_pad``;
``store_dtype=torch.bfloat16`` halves the features, at bfloat16's
rounding of [0, 1] mels (under 4e-3).
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.data import prepare
from speechsplit_tpu_torch.data.collator import Batch
from speechsplit_tpu_torch.data.dataset import SpeakerDataset
from speechsplit_tpu_torch.data.prefetch import stack_batches
from speechsplit_tpu_torch.data.sampler import RepeatSampler
from speechsplit_tpu_torch.parallel.mesh import Mesh, shard_batch
from speechsplit_tpu_torch.preprocess import extract_into_store
from speechsplit_tpu_torch.training.train_step import (
    TrainState,
    make_train_multi_step,
)

UNVOICED = -1e10


class ResidentFeatures(NamedTuple):
    mel: torch.Tensor      # [U, T_pad, dim_freq], zero past each length
    f0: torch.Tensor       # [U, T_pad], UNVOICED past each length
    spk_emb: torch.Tensor  # [U, dim_spk_emb] float32
    length: torch.Tensor   # [U] int32 frame counts


class Plan(NamedTuple):
    """One call's crop coordinates, ``[B]`` or ``[k, B]`` each (numpy on
    the host, tensors once prefetched)."""

    utt: np.ndarray       # utterance ids into ResidentFeatures
    len_crop: np.ndarray  # crop lengths
    offset: np.ndarray    # crop start frames


def build_resident(
    dataset: SpeakerDataset,
    config: SpeechSplitConfig,
    store_dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[ResidentFeatures, list]:
    """Every utterance of ``dataset`` on ``device`` (``cuda`` unless
    told otherwise) once (resident.py:71-115). The host arrays are built
    in the store's dtype before the upload, so a bfloat16 store uploads
    half the bytes.

    Returns (features, speaker_utts): ``speaker_utts[i]`` lists speaker
    i's flat utterance ids, speaker-major in the dataset's order, the
    structure :func:`plan_batches` draws from."""
    dev = resolve_device(device)
    mels, f0s, embs, lens, speaker_utts = [], [], [], [], []
    for _name, emb, utts in dataset.entries:
        ids = []
        for mel, f0 in utts:
            ids.append(len(mels))
            mels.append(np.asarray(mel, np.float32))
            f0s.append(np.asarray(f0, np.float32))
            embs.append(np.asarray(emb, np.float32))
            lens.append(len(mels[-1]))
        speaker_utts.append(ids)

    # a max_len_pad window fits at any offset the plans draw
    t_pad = max(lens) + config.max_len_pad
    mel_arr = torch.zeros((len(mels), t_pad, config.dim_freq),
                          dtype=store_dtype)
    f0_arr = torch.full((len(mels), t_pad), UNVOICED, dtype=store_dtype)
    for i, (m, f) in enumerate(zip(mels, f0s)):
        # float32 first, then the store's rounding (JAX's order)
        mel_arr[i, : len(m)] = torch.from_numpy(m)
        f0_arr[i, : len(f)] = torch.from_numpy(f)
    features = ResidentFeatures(
        mel=prepare._upload(mel_arr, dev),
        f0=prepare._upload(f0_arr, dev),
        spk_emb=prepare._upload(np.stack(embs), dev),
        length=prepare._upload(np.asarray(lens, np.int32), dev),
    )
    return features, speaker_utts


def build_resident_from_wavs(
    wav_dir: str,
    spk2gen: dict,
    config: SpeechSplitConfig,
    store_dtype: torch.dtype = torch.float32,
    *,
    batch_size: int = 16,
    seed: int = 0,
    batches_per_dispatch: int = 8,
    reference_compat: bool = False,
    device=None,
    dither: Optional[Callable[[int, int, tuple], torch.Tensor]] = None,
) -> Tuple[ResidentFeatures, list]:
    """A wav tree extracted on ``device`` straight into the feature store
    (resident.py:118-257): no feature crosses to the host.

    The walk is ``data.prepare.extract_dir``'s: the same sorted entries,
    the same batches and groups (``_staged_groups``), and the same dither
    draws, a ``torch.Generator`` on ``device`` seeded with ``seed`` drawn
    group after group, batch after batch (or ``dither(group, k, shape)``,
    the hook ``extract_dir`` has). Each group is extracted by
    ``preprocess.extract_into_store``, masked past each utterance's
    frames and written at its row. So a bfloat16 store equals
    ``extract_dir(compress_fetch=True)`` -> ``build_metadata`` ->
    ``SpeakerDataset`` -> :func:`build_resident` (bfloat16) bit for bit,
    and a float32 one the same without ``compress_fetch``.

    Utterance ids are speaker-major in sorted-file order, the order
    ``build_metadata`` lists them; embeddings as ``build_metadata``'s
    (``reference_compat`` as there). On CUDA a group's arrays are copied
    from pinned memory on a side stream while the group before it is
    extracted.

    Returns (features, speaker_utts), as :func:`build_resident`."""
    dev = resolve_device(device)
    speakers, entries = prepare._enumerate_entries(wav_dir, spk2gen)
    by_speaker: dict = {}
    for e in sorted(entries, key=lambda e: (e[0], e[1])):
        by_speaker.setdefault(e[0], []).append(e)
    uid_of, speaker_utts, embs, frames = {}, [], [], []
    for idx, speaker in enumerate(speakers):
        emb = prepare.speaker_embedding(speaker, idx, config.dim_spk_emb,
                                        reference_compat)
        ids = []
        for _spk, fname, _lo, _hi, _size in by_speaker.get(speaker, []):
            uid_of[(speaker, fname)] = len(frames)
            ids.append(len(frames))
            embs.append(emb)
            frames.append(prepare.wav_frame_count(
                os.path.join(wav_dir, speaker, fname)))
        speaker_utts.append(ids)
    if not frames:
        raise ValueError(f"no wavs under {wav_dir}")

    t_pad = max(frames) + config.max_len_pad
    mel_store = torch.zeros((len(frames), t_pad, config.dim_freq),
                            dtype=store_dtype, device=dev)
    f0_store = torch.full((len(frames), t_pad), UNVOICED, dtype=store_dtype,
                          device=dev)
    generator = None
    if dither is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(group):
        """Queue one group's upload; returns what ``extract`` takes."""
        arrays = (np.stack([b for _j, b, _l in group]),
                  np.stack([l for _j, _b, l in group]).astype(np.int64),
                  np.array([[e[2] for e in j] for j, _b, _l in group],
                           np.float32),
                  np.array([[e[3] for e in j] for j, _b, _l in group],
                           np.float32))
        uids = np.array([[uid_of[(spk, f)] for spk, f, _lo, _hi in j]
                         for j, _b, _l in group], np.int32)
        host = [torch.from_numpy(a) for a in arrays]
        if copy_stream is None:
            return host, uids, None
        with torch.cuda.stream(copy_stream):
            moved = [t.pin_memory().to(dev, non_blocking=True) for t in host]
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return moved, uids, ready

    def extract(index, staged):
        (wavs, lengths, lo, hi), uids, ready = staged
        if ready is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ready)
            for t in (wavs, lengths, lo, hi):
                t.record_stream(stream)
        draws = None
        if dither is not None:
            draws = [prepare._as_draws(dither(index, k, tuple(wavs.shape[1:])))
                     for k in range(len(wavs))]
        extract_into_store(mel_store, f0_store, wavs, lengths, lo, hi, uids,
                           uniform=draws, generator=generator)

    groups = prepare._staged_groups(wav_dir, entries, batch_size=batch_size,
                                    batches_per_dispatch=batches_per_dispatch)
    pending = None
    try:
        for index, (group, _k_real) in enumerate(groups):
            staged = stage(group)  # in flight while the group before runs
            if pending is not None:
                extract(*pending)
            pending = (index, staged)
        if pending is not None:
            extract(*pending)
    finally:
        groups.close()
    features = ResidentFeatures(
        mel=mel_store,
        f0=f0_store,
        spk_emb=prepare._upload(np.stack(embs), dev),
        length=prepare._upload(np.asarray(frames, np.int32), dev),
    )
    return features, speaker_utts


def plan_batches(
    speaker_utts: list,
    lengths: np.ndarray,
    config: SpeechSplitConfig,
    *,
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[Plan]:
    """Endless ``[B]`` crop plans drawing as the host loader does
    (resident.py:260-302): the sampler's epoch, then each speaker's
    utterance pick, then each crop's length and offset, all from one
    ``np.random.default_rng(seed)`` (loader.py, dataset.py, collator.py).
    ``lengths`` are the utterances' frame counts on the host."""
    sampler = RepeatSampler(len(speaker_utts), config.n_repeats,
                            shuffle=config.shuffle)
    rng = np.random.default_rng(seed)
    b = config.batch_size
    lengths = np.asarray(lengths)
    while True:
        order = sampler.epoch(rng)
        for start in range(0, len(order), b):
            idx = order[start : start + b]
            if drop_last and len(idx) < b:
                break
            utt_ids = []
            for spk in idx:
                ids = speaker_utts[int(spk)]
                utt_ids.append(ids[rng.integers(len(ids))] if len(ids) > 1
                               else ids[0])
            len_crops, offsets = [], []
            for uid in utt_ids:
                t = int(lengths[uid])
                lc = int(rng.integers(config.min_len_seq,
                                      config.max_len_seq + 1))
                lc = min(lc, t, config.max_len_pad)
                offsets.append(int(rng.integers(0, max(t - lc, 0) + 1)))
                len_crops.append(lc)
            yield Plan(utt=np.asarray(utt_ids, np.int32),
                       len_crop=np.asarray(len_crops, np.int32),
                       offset=np.asarray(offsets, np.int32))


def stack_plans(plans: Iterator[Plan], k: int) -> Iterator[Plan]:
    """k plans as one ``[k, B]`` plan (resident.py:305-312), for a
    k-step call of :func:`make_resident_train_step`."""
    return stack_batches(plans, k)


def collate_on_device(config: SpeechSplitConfig, features: ResidentFeatures,
                      plan: Plan) -> Batch:
    """The collator on the store's device (resident.py:315-343): for a
    ``[B]`` or ``[k, B]`` plan, one gather of ``max_len_pad`` frames from
    each row's offset, then float32, mel clipped to [0, 1], and past each
    crop's length mel 0 and F0 ``UNVOICED``. The same ``Batch`` as
    ``data.Collator`` on the same draws, bit for bit."""
    dev = features.mel.device
    utt, len_crop, offset = (torch.as_tensor(x, device=dev) for x in plan)
    utt = utt.long()
    frames = torch.arange(config.max_len_pad, device=dev)
    index = offset.long()[..., None] + frames  # [..., T]
    mel = features.mel[utt[..., None], index].float()
    f0 = features.f0[utt[..., None], index].float()
    keep = frames < len_crop[..., None]
    mel = torch.where(keep[..., None], torch.clamp(mel, 0.0, 1.0), 0.0)
    f0 = torch.where(keep, f0, UNVOICED)
    return Batch(mel=mel, spk_emb=features.spk_emb[utt].float(),
                 f0=f0[..., None], len_org=len_crop)


def make_resident_train_step(
    config: SpeechSplitConfig,
    features: ResidentFeatures,
    model: str = "speechsplit",
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Plan], Tuple[TrainState, torch.Tensor]]:
    """Train steps driven by crop plans (resident.py:346-415):
    ``step(state, plan)`` gathers the plan's batch from ``features`` and
    runs the generator's (``model="speechsplit"``) or the F0 converter's
    step on it; a ``[B]`` plan is one step, ``(state, loss)``, a
    ``[k, B]`` plan k steps, ``(state, losses[k])``, by
    ``make_train_multi_step``. The store is held by reference; the state
    carries the model, so JAX's module argument has no counterpart.

    With a ``mesh`` every rank holds the whole store, as JAX replicates
    it; the plan is the global batch's, and each rank gathers its own
    rows of it and steps on them (``make_train_multi_step`` on the
    mesh)."""
    multi = make_train_multi_step(config, model, mesh)

    def step(state: TrainState, plan: Plan):
        if mesh is not None:
            plan = shard_batch(mesh, plan, axis=plan.utt.ndim - 1)
        batch = collate_on_device(config, features, plan)
        if plan.utt.ndim == 1:
            state, losses = multi(state, Batch(*(x[None] for x in batch)))
            return state, losses[0]
        return multi(state, batch)

    return step
