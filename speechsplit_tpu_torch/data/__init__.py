"""Host-side data pipeline of the port: feature store, sampler,
random-crop collation, loader and background transfer to the card."""

from speechsplit_tpu_torch.data.collator import Batch, Collator
from speechsplit_tpu_torch.data.dataset import SpeakerDataset, load_metadata
from speechsplit_tpu_torch.data.loader import data_loader
from speechsplit_tpu_torch.data.prefetch import prefetch_to_device
from speechsplit_tpu_torch.data.sampler import RepeatSampler

__all__ = [
    "Batch",
    "Collator",
    "SpeakerDataset",
    "load_metadata",
    "RepeatSampler",
    "data_loader",
    "prefetch_to_device",
]
