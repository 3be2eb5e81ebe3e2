"""Epoch index sampling: each speaker visited ``n_repeats`` times
(counterpart of speechsplit_tpu/data/sampler.py: one numpy
``Generator`` gives the same epochs in both packages).

Reference: MultiSampler (data_loader.py:133-151, ``samplier=8``), with
its length computed statically instead of after the first ``__iter__``.
"""

from __future__ import annotations

import numpy as np


class RepeatSampler:
    def __init__(
        self, num_samples: int, n_repeats: int, shuffle: bool = True
    ):
        self.num_samples = num_samples
        self.n_repeats = n_repeats
        self.shuffle = shuffle

    def __len__(self) -> int:
        return self.num_samples * self.n_repeats

    def epoch(self, rng: np.random.Generator) -> np.ndarray:
        idx = np.tile(np.arange(self.num_samples), self.n_repeats)
        if self.shuffle:
            rng.shuffle(idx)
        return idx
