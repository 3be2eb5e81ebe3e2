"""speechsplit_tpu_torch — the PyTorch/CUDA port of speechsplit_tpu.

Runs the SpeechSplit generator and the F0 converter on an NVIDIA Hopper
card (H100). Module names mirror the JAX package so that each module's
counterpart is easy to find; the port imports nothing of that package.

Every recurrence on the serving, conversion and training paths runs in
a CUDA kernel written for ``sm_90a`` (``csrc/``): ``ops.bilstm`` (one
BiLSTM layer, both directions in one launch), ``ops.multi_bilstm`` (N
independent narrow BiLSTMs in one launch) and ``ops.lstm`` (one
direction), each with a lean forward for inference and, under autograd,
a residual-saving forward and a gradient kernel; and the pitch tracker's
Viterbi decoder (``ops.pitch.viterbi_decode``). On CPU tensors the same
functions run their plain PyTorch versions, which is how the tests hold
the port to JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:
serving (``pipeline.VoiceConverter``, ``cli.serve``), feature extraction
(``preprocess.extract_features``), corpus preparation
(``data.prepare.extract_dir``, ``cli.preprocess``; ``cli.metadata`` is
host work), synthesis (``vocoder.GriffinLimVocoder``,
``vocoder_neural.load_vocoder``), conversion (``convert``,
``cli.convert``) and training (``training.create_train_state``,
``training.make_train_step``, ``training.make_f0_train_step``,
``training.make_train_multi_step``, ``training.Solver``, ``cli.train``,
the device-resident store ``data.resident.build_resident`` and
``build_resident_from_wavs``, and the vocoder's
``vocoder_neural.VocoderTrainer``, ``cli.train_vocoder``).
Each runs one-hot speaker embeddings or, with
``spk_emb_mode="learned"``, the SpeakerEncoder's zero-shot ones.
"""

from __future__ import annotations

import torch

from speechsplit_tpu_torch.config import SpeechSplitConfig

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    With no device given and no CUDA present this raises instead of
    quietly running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "speechsplit_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


_TRAINING = ("TrainState", "create_train_state", "make_train_step",
             "make_f0_train_step", "Solver", "SolverConfig")


def __getattr__(name):
    if name in ("SpeechSplit", "F0Converter"):
        from speechsplit_tpu_torch import models

        return getattr(models, name)
    if name in _TRAINING:
        from speechsplit_tpu_torch import training

        return getattr(training, name)
    raise AttributeError(name)


__all__ = [
    "SpeechSplitConfig",
    "resolve_device",
    "SpeechSplit",
    "F0Converter",
    *_TRAINING,
    "__version__",
]
