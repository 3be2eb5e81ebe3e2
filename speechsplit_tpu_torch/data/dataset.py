"""Feature store keyed by speaker (counterpart of
speechsplit_tpu/data/dataset.py; numpy only).

Mirrors the reference ``Utterances`` dataset (data_loader.py:14-91):
the metadata is ``train.pkl``; ``__len__`` is the number of *speakers*
and :meth:`SpeakerDataset.get` returns one (mel, spk_emb, f0) utterance
of a speaker. Files load on a thread pool (``.npy`` reads are I/O
bound). With several utterances a speaker, ``get`` picks one with the
loader's shared ``np.random.Generator``, drawing exactly as the JAX
package does, so that the loader's batches stay bit-identical.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np


def load_metadata(root_dir: str, name: str = "train.pkl") -> list:
    """The metadata pickle: ``[speaker, emb, rel_path, ...]`` entries.
    Unpickling runs code: load only files this project or the reference
    wrote."""
    with open(os.path.join(root_dir, name), "rb") as handle:
        return pickle.load(handle)


class LazyArray:
    """A file-backed utterance slice that opens its ``.npy`` on access.

    Stores only (path, start, stop); every access opens the file, copies
    the requested frames and lets the descriptor close, so the number of
    open files is bounded by what one batch reads, not by corpus size.
    """

    __slots__ = ("path", "start", "stop")

    def __init__(self, path: str, start: int, stop: int):
        self.path, self.start, self.stop = path, start, stop

    def __len__(self) -> int:
        return self.stop - self.start

    def _view(self) -> np.ndarray:
        return np.load(self.path, mmap_mode="r")[self.start : self.stop]

    def __getitem__(self, index) -> np.ndarray:
        # a copy, so the memmap's descriptor closes with the temporary
        return np.array(self._view()[index], copy=True)

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = np.array(self._view(), copy=True)
        return out.astype(dtype) if dtype is not None else out


def _npy_frame_count(path: str) -> int:
    """First-axis length from the ``.npy`` header (no data read)."""
    return int(np.load(path, mmap_mode="r").shape[0])


class SpeakerDataset:
    """One entry per speaker: (speaker, embedding, [(mel, f0), ...])."""

    def __init__(
        self,
        root_dir: str,
        feat_dir: str,
        *,
        metadata: list | None = None,
        num_workers: int = 8,
        mode: str = "train",
        split: int = 0,
        eager: bool = True,
    ):
        """``mode``/``split`` are the reference's frame-level partition
        (data_loader.py:23,64-69): "train" keeps frames [split:] of every
        utterance, "test" keeps [:split] (the default split=0 leaves the
        test set empty, as in the reference).

        ``eager=False`` keeps :class:`LazyArray` handles instead of RAM
        copies (a corpus larger than host RAM): only the ``.npy`` headers
        are read here.
        """
        if mode not in ("train", "test"):
            raise ValueError(mode)
        self.root_dir = root_dir
        self.feat_dir = feat_dir
        meta = metadata if metadata is not None else load_metadata(root_dir)

        def load_entry(entry):
            speaker, emb = entry[0], np.asarray(entry[1], np.float32)
            utts = []
            for rel in entry[2:]:
                mel_path = os.path.join(root_dir, rel)
                f0_path = os.path.join(feat_dir, rel)
                if eager:
                    mel = np.load(mel_path)
                    f0 = np.load(f0_path)
                    if len(mel) != len(f0):
                        raise ValueError(
                            f"{rel}: {len(mel)} mel frames, {len(f0)} F0")
                    if mode == "train":
                        mel, f0 = mel[split:], f0[split:]
                    else:
                        mel, f0 = mel[:split], f0[:split]
                    utts.append((mel, f0))
                else:
                    t = _npy_frame_count(mel_path)
                    if t != _npy_frame_count(f0_path):
                        raise ValueError(f"{rel}: mel and F0 lengths differ")
                    start, stop = (split, t) if mode == "train" else (0, split)
                    utts.append((LazyArray(mel_path, start, stop),
                                 LazyArray(f0_path, start, stop)))
            return speaker, emb, utts

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            self.entries: List[Tuple[str, np.ndarray, list]] = list(
                pool.map(load_entry, meta)
            )

    def __len__(self) -> int:
        return len(self.entries)

    def speakers(self) -> Sequence[str]:
        return [e[0] for e in self.entries]

    def get(
        self, index: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(mel [T, 80], spk_emb [82], f0 [T]) of one utterance of the
        speaker at ``index``; draws from ``rng`` only when the speaker
        has more than one utterance."""
        speaker, emb, utts = self.entries[index]
        utt = utts[rng.integers(len(utts))] if len(utts) > 1 else utts[0]
        return utt[0], emb, utt[1]
