"""Host-side data for training: the random-crop collator (the dataset,
sampler and loader are a later slice of the port)."""

from speechsplit_tpu_torch.data.collator import Batch, Collator

__all__ = ["Batch", "Collator"]
