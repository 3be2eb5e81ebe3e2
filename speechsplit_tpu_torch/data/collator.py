"""Random-crop collation into fixed-geometry training batches
(counterpart of speechsplit_tpu/data/collator.py, line for line, so that
one ``np.random.Generator`` seed gives bit-identical batches in both
packages).

Reference: MyCollator (data_loader.py:95-128). Per sample: crop a random
window of U{min_len_seq .. max_len_seq} frames (~1.5-3 s) at a random
offset, clip mel to [0, 1], zero-pad mel to ``max_len_pad`` and pad F0
with the -1e10 unvoiced sentinel so quantization maps padding to bin 0
(data_loader.py:106-116). As in the JAX package, a short utterance caps
the crop length at its own length instead of crashing ``randint``.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple

import numpy as np

from speechsplit_tpu_torch.config import SpeechSplitConfig


class Batch(NamedTuple):
    mel: np.ndarray        # [B, max_len_pad, dim_freq] in [0, 1]
    spk_emb: np.ndarray    # [B, dim_spk_emb]
    f0: np.ndarray         # [B, max_len_pad, 1], -1e10 padded
    len_org: np.ndarray    # [B] crop lengths


class Collator:
    def __init__(self, config: SpeechSplitConfig):
        self.min_len_seq = config.min_len_seq
        self.max_len_seq = config.max_len_seq
        self.max_len_pad = config.max_len_pad

    def __call__(
        self,
        samples: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        rng: np.random.Generator,
    ) -> Batch:
        mels, embs, f0s, lens = [], [], [], []
        for mel, emb, f0 in samples:
            t = len(mel)
            len_crop = int(
                rng.integers(
                    self.min_len_seq,
                    self.max_len_seq + 1,
                )
            )
            len_crop = min(len_crop, t, self.max_len_pad)
            left = int(rng.integers(0, max(t - len_crop, 0) + 1))

            a = np.clip(mel[left : left + len_crop], 0.0, 1.0)
            c = f0[left : left + len_crop]

            a_pad = np.pad(
                a,
                ((0, self.max_len_pad - len_crop), (0, 0)),
                "constant",
            )
            c_pad = np.pad(
                c[:, None],
                ((0, self.max_len_pad - len_crop), (0, 0)),
                "constant",
                constant_values=-1e10,
            )
            mels.append(a_pad)
            embs.append(emb)
            f0s.append(c_pad)
            lens.append(len_crop)

        return Batch(
            mel=np.stack(mels).astype(np.float32),
            spk_emb=np.stack(embs).astype(np.float32),
            f0=np.stack(f0s).astype(np.float32),
            len_org=np.asarray(lens, np.int32),
        )
