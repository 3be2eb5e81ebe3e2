"""Batch iterator wiring dataset + collator + sampler (counterpart of
speechsplit_tpu/data/loader.py, line for line, so that one seed gives
bit-identical batches in both packages).

Replaces the reference's torch DataLoader composition (data_loader.py:
156-175: batch 16, drop_last, repeat-sampler, worker seeding) with a
plain generator of numpy batches; collation at this model's geometry is
microseconds of numpy, and the transfer to the card runs in the
background (:mod:`speechsplit_tpu_torch.data.prefetch`).

On a data mesh every rank runs this loader from the same seed and keeps
its rows of each batch (``training.Solver``, ``parallel.shard_batch``):
the crops draw from one sequential ``rng``, so only the global walk
gives every rank the batches one process would see.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.data.collator import Batch, Collator
from speechsplit_tpu_torch.data.dataset import SpeakerDataset
from speechsplit_tpu_torch.data.sampler import RepeatSampler


def data_loader(
    dataset: SpeakerDataset,
    config: SpeechSplitConfig,
    *,
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[Batch]:
    """Infinite iterator of collated numpy batches (epochs roll over, as
    the reference restarts its iterator on StopIteration, solver.py:
    141-145). The sampler's shuffle, each speaker's utterance pick and
    each crop all draw from one ``np.random.default_rng(seed)``, in that
    order."""
    collator = Collator(config)
    sampler = RepeatSampler(
        len(dataset), config.n_repeats, shuffle=config.shuffle
    )
    rng = np.random.default_rng(seed)
    batch_size = config.batch_size
    while True:
        order = sampler.epoch(rng)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            samples = [dataset.get(int(i), rng) for i in idx]
            yield collator(samples, rng)
