"""Corpus preparation: a wav tree -> ``.npy`` feature trees + metadata
(counterpart of speechsplit_tpu/data/prepare.py; reference
make_spect_f0.py and make_metadata.py).

``wav_dir/<speaker>/*.wav`` becomes ``mel_dir/<speaker>/<utt>.npy`` (mel
[T, 80]) and ``f0_dir/<speaker>/<utt>.npy`` (normalized log-F0 [T]),
trimmed to ``frame_count(length)`` frames, and ``build_metadata`` writes
``mel_dir/train.pkl`` (``[[speaker, spk_emb(82,), relpath, ...], ...]``,
make_metadata.py:10-33) in the JAX package's format, which
``cli.train`` reads as it is.

Speaker embeddings: a one-hot slot each speaker by sorted order;
``reference_compat=True`` gives the reference's hard-coded slots (p226
-> slot 1, everyone else -> slot 7; make_metadata.py:20-24).
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from scipy.io import wavfile

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.preprocess import (
    GENDER_F0_RANGE,
    extract_features_scan,
    frame_count,
    pad_batch,
)

# the padded batch length's bucket in samples (JAX extract_dir's
# pad_batch(bucket=8192): half a second at 16 kHz)
BUCKET = 8192


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


def wav_frame_count(path: str, hop: int = 256) -> int:
    """The frames a wav gives (``samples // hop + 1``), from its header
    alone; a file the ``wave`` module cannot parse is decoded."""
    import wave

    try:
        with wave.open(path, "rb") as handle:
            return handle.getnframes() // hop + 1
    except wave.Error:
        return len(read_wav_pcm(path)) // hop + 1


def list_wavs(wav_dir: str) -> List[str]:
    """Every ``.wav`` under ``wav_dir``: a sorted ``os.walk``, sorted file
    names (the order ``cli.train_vocoder``'s ``--max_files`` cuts)."""
    paths = []
    for root, _dirs, files in sorted(os.walk(wav_dir)):
        for name in sorted(files):
            if name.endswith(".wav"):
                paths.append(os.path.join(root, name))
    return paths


def _speakers(root: str) -> List[str]:
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def _enumerate_entries(wav_dir: str, spk2gen: Dict[str, str]) -> tuple:
    """(speakers, entries): the sorted speaker directories and one
    ``(speaker, fname, f0_lo, f0_hi, byte_size)`` a wav, sorted by
    ``(size, speaker, fname)``, so that a batch's members have nearly its
    padded length and neighbouring batches share a shape."""
    speakers = _speakers(wav_dir)
    entries: List[tuple] = []
    for speaker in speakers:
        lo, hi = GENDER_F0_RANGE[spk2gen[speaker]]
        for f in sorted(f for f in os.listdir(os.path.join(wav_dir, speaker))
                        if f.endswith(".wav")):
            size = os.path.getsize(os.path.join(wav_dir, speaker, f))
            entries.append((speaker, f, lo, hi, size))
    entries.sort(key=lambda e: (e[4], e[0], e[1]))
    return speakers, entries


def _staged_groups(
    wav_dir: str,
    entries: Sequence[tuple],
    *,
    batch_size: int = 16,
    batches_per_dispatch: int = 8,
    stats: Optional[dict] = None,
) -> Iterable[tuple]:
    """Decode, batch and group the corpus ahead of the card.

    A reader thread decodes (PCM16 kept) and pads batches of
    ``batch_size`` entries to a multiple of :data:`BUCKET` samples; the
    generator groups consecutive same-shape batches up to
    ``batches_per_dispatch`` deep and yields ``(group, k_real)``: a list
    of the ``k_real`` real ``(job, batch, lengths)`` tuples (``job`` =
    ``[(speaker, fname, f0_lo, f0_hi), ...]``), JAX's group without the
    repeats that fill a short one up to its compiled program's depth. A
    reader error is raised here; closing the generator stops the reader.
    ``stats["read"]`` sums the reader's seconds."""
    jobs = [[e[:4] for e in entries[start : start + batch_size]]
            for start in range(0, len(entries), batch_size)]
    ready: queue.Queue = queue.Queue(maxsize=2 * max(1, batches_per_dispatch))
    stop = threading.Event()

    def put(item) -> bool:
        """Queue ``item`` unless the consumer has stopped (False then)."""
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def read_jobs():
        try:
            for job in jobs:
                start = time.perf_counter()
                wavs = [read_wav_pcm(os.path.join(wav_dir, spk, f))
                        for spk, f, _lo, _hi in job]
                batch, lengths = pad_batch(wavs, bucket=BUCKET)
                if stats is not None:
                    stats["read"] = stats.get("read", 0.0) + (
                        time.perf_counter() - start)
                if not put((job, batch, lengths)):
                    return
        except Exception as exc:  # raised by the consumer
            put(exc)
            return
        put(None)

    reader = threading.Thread(target=read_jobs, daemon=True)
    reader.start()
    pending: List[tuple] = []
    try:
        while True:
            item = ready.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            batch = item[1]
            if pending and (pending[0][1].shape != batch.shape
                            or pending[0][1].dtype != batch.dtype
                            or len(pending) >= batches_per_dispatch):
                yield list(pending), len(pending)
                pending.clear()
            pending.append(item)
        if pending:
            yield list(pending), len(pending)
    finally:
        stop.set()
        reader.join()


def _upload(array, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``: through pinned memory
    without waiting for the card on CUDA (a pageable upload waits for the
    stream)."""
    tensor = (array if isinstance(array, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(array)))
    if device.type != "cuda":
        return tensor
    return tensor.pin_memory().to(device, non_blocking=True)


def _as_draws(draws) -> torch.Tensor:
    if isinstance(draws, torch.Tensor):
        return draws
    return torch.from_numpy(np.array(draws, np.float32))


def extract_dir(
    wav_dir: str,
    mel_dir: str,
    f0_dir: str,
    spk2gen: Dict[str, str],
    *,
    batch_size: int = 16,
    seed: int = 0,
    batches_per_dispatch: int = 8,
    compress_fetch: bool = False,
    writer_threads: int = 4,
    device=None,
    dither: Optional[Callable[[int, int, tuple], torch.Tensor]] = None,
    stats: Optional[dict] = None,
) -> List[str]:
    """Every ``wav_dir/<speaker>/*.wav`` into the two feature trees
    (prepare.py:209-344); returns the sorted speakers.

    A pipeline of three stages:

    1. a reader thread decodes and pads batches of all files sorted by
       size (:func:`_staged_groups`); each batch carries the F0 bounds of
       its members' genders (``spk2gen``, ``GENDER_F0_RANGE``);
    2. each group of up to ``batches_per_dispatch`` same-shape batches
       is uploaded and extracted on ``device`` (``cuda`` unless given;
       :func:`preprocess.extract_features_scan`, one pitch-decoder launch
       a batch), its results copied to pinned host memory on a side
       stream; the next group is queued before the previous one's copy
       is awaited, so the card computes while the host writes (a short
       group as it is: JAX fills it up with repeats of its last batch);
    3. ``.npy`` writes on a ``writer_threads`` pool, the fetch loop held
       back while more than ``16 * writer_threads`` writes are pending.

    The dither: ``dither(group, k, shape)``, if given, returns batch k of
    group ``group``'s [B, N] U(0, 1) draws, a tensor on any device or an
    array (the tests pass JAX's); else a
    ``torch.Generator`` on ``device`` seeded with ``seed`` draws them
    (the same distribution as JAX's; the stream differs).
    ``compress_fetch`` fetches bfloat16 features (the files stay
    float32). ``stats``, if given, gets the seconds of each stage summed:
    ``read`` (decode and pad, on the reader thread), ``dispatch``
    (queueing the extraction), ``fetch`` (waiting for a group's features
    on the host) and ``write`` (``np.save``, summed over the writers)."""
    dev = resolve_device(device)
    speakers, entries = _enumerate_entries(wav_dir, spk2gen)
    for speaker in speakers:
        os.makedirs(os.path.join(mel_dir, speaker), exist_ok=True)
        os.makedirs(os.path.join(f0_dir, speaker), exist_ok=True)
    stats = {} if stats is None else stats
    for key in ("read", "dispatch", "fetch", "write"):
        stats.setdefault(key, 0.0)
    lock = threading.Lock()
    generator = None
    if dither is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    writers = ThreadPoolExecutor(max_workers=writer_threads)
    write_futures: List = []

    def save(path, array):
        start = time.perf_counter()
        np.save(path, array, allow_pickle=False)
        with lock:
            stats["write"] += time.perf_counter() - start

    def dispatch(group, index):
        """Queue one group's extraction and its copy to the host."""
        start = time.perf_counter()
        wavs = np.stack([b for _j, b, _l in group])
        lengths = np.stack([l for _j, _b, l in group]).astype(np.int64)
        lo = np.array([[e[2] for e in j] for j, _b, _l in group], np.float32)
        hi = np.array([[e[3] for e in j] for j, _b, _l in group], np.float32)
        draws = None
        if dither is not None:
            draws = [_as_draws(dither(index, k, wavs.shape[1:]))
                     for k in range(len(group))]
        mel, f0 = extract_features_scan(
            _upload(wavs, dev), _upload(lengths, dev), _upload(lo, dev),
            _upload(hi, dev), uniform=draws, generator=generator,
            compress=compress_fetch, device=dev)
        done = None
        if copy_stream is not None:
            ready = torch.cuda.Event()
            ready.record()
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(ready)
                host = []
                for x in (mel, f0):
                    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    h.copy_(x, non_blocking=True)
                    x.record_stream(copy_stream)
                    host.append(h)
                done = torch.cuda.Event()
                done.record(copy_stream)
            mel, f0 = host
        stats["dispatch"] += time.perf_counter() - start
        return mel, f0, done

    def drain_one():
        group, mel, f0, done = in_flight.pop(0)
        start = time.perf_counter()
        if done is not None:
            done.synchronize()
        mel_host = mel.float().numpy()
        f0_host = f0.float().numpy()
        stats["fetch"] += time.perf_counter() - start
        for k, (job, _batch, lengths) in enumerate(group):
            for i, (speaker, fname, _lo, _hi) in enumerate(job):
                t = frame_count(int(lengths[i]))
                stem = fname[:-4]
                write_futures.append(writers.submit(
                    save, os.path.join(mel_dir, speaker, stem),
                    mel_host[k, i, :t]))
                write_futures.append(writers.submit(
                    save, os.path.join(f0_dir, speaker, stem),
                    f0_host[k, i, :t]))
        # backpressure: a slow disk stalls the fetch loop instead of
        # queueing the corpus's features in pending writes
        while len(write_futures) > 16 * writer_threads:
            write_futures.pop(0).result()

    in_flight: List[tuple] = []
    groups = _staged_groups(wav_dir, entries, batch_size=batch_size,
                            batches_per_dispatch=batches_per_dispatch,
                            stats=stats)
    try:
        for index, (group, _k_real) in enumerate(groups):
            in_flight.append((group, *dispatch(group, index)))
            while len(in_flight) > 1:  # fetch the older while this computes
                drain_one()
        while in_flight:
            drain_one()
        for fut in write_futures:
            fut.result()  # surface any write error
    finally:
        groups.close()  # stops the reader if a stage raised
        writers.shutdown()
    return speakers


def speaker_embedding(speaker: str, index: int, dim: int = 82,
                      reference_compat: bool = False) -> np.ndarray:
    """A speaker's one-hot embedding: slot ``index % dim``, or the
    reference's slots with ``reference_compat`` (make_metadata.py:20-24)."""
    emb = np.zeros((dim,), np.float32)
    if reference_compat:
        emb[1 if speaker == "p226" else 7] = 1.0
    else:
        emb[index % dim] = 1.0
    return emb


def build_metadata(mel_dir: str, *, dim_spk_emb: int = 82,
                   reference_compat: bool = False,
                   out_name: str = "train.pkl") -> list:
    """Walk the mel tree and write ``mel_dir/out_name``: one
    ``[speaker, embedding, relpath, ...]`` entry a speaker, the speakers
    and their files sorted (make_metadata.py)."""
    meta = []
    for idx, speaker in enumerate(_speakers(mel_dir)):
        entry: list = [speaker, speaker_embedding(
            speaker, idx, dim_spk_emb, reference_compat)]
        for fname in sorted(f for f in os.listdir(os.path.join(mel_dir,
                                                               speaker))
                            if f.endswith(".npy")):
            entry.append(os.path.join(speaker, fname))
        meta.append(entry)
    with open(os.path.join(mel_dir, out_name), "wb") as handle:
        pickle.dump(meta, handle)
    return meta
