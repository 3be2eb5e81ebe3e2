"""Training steps for both models (counterpart of
speechsplit_tpu/training/train_step.py).

The generator step, as in the reference's hot loop (solver.py:134-172):
1. concat mel and normalized F0 into ``[B, T, 81]``;
2. random-resample that stack (the standalone augmentation before the
   model, solver.py:60,161);
3. re-quantize the resampled F0 channel to a 257-bin one-hot;
4. forward through the generator in train mode (its encoders resample
   again) and take the mean-MSE identity loss (solver.py:165-166);
5. backward, then Adam (lr 1e-4, betas (0.9, 0.999), main.py:42-44).

The F0-converter step is the JAX package's addition: masked softmax
cross-entropy of the predicted 257-bin contour against the quantized
source contour.

All resampling draws of a step come from ``TrainState.generator`` (a
CPU ``torch.Generator``, see ``ops.interp``), the augmentation's before
the model's, as the JAX step splits its key. Every recurrence of the
step runs through ``ops.bilstm`` / ``ops.multi_bilstm``, whose
``autograd.Function`` launches the residual-saving forward and gradient
kernels on the card.

Precision: the port trains with float32 residuals, float32 Adam moments
and float32 gradients. The JAX defaults ``residual_dtype="bfloat16"``
and ``adam_mu_dtype="bfloat16"`` raise ``NotImplementedError`` (queued
in ROADMAP.md); pass ``residual_dtype="float32",
adam_mu_dtype="float32"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.data.collator import Batch
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.ops.interp import random_resample
from speechsplit_tpu_torch.ops.quantize import quantize_f0, quantize_f0_onehot

# optax.adam's default epsilon (torch's Adam has the same default)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    """A model, its Adam optimizer, the step count and the CPU generator
    of the resampling draws. A step updates it in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def check_precision(config: SpeechSplitConfig) -> None:
    """Refuse the precision settings the port does not run yet."""
    for name in ("residual_dtype", "adam_mu_dtype", "grad_dtype"):
        value = getattr(config, name)
        if value != "float32":
            raise NotImplementedError(
                f"{name}={value!r}: the port trains with float32 residuals, "
                "Adam moments and gradients; bfloat16 is queued in "
                "ROADMAP.md (pass float32)"
            )
    if config.spk_emb_mode != "onehot":
        raise NotImplementedError(
            "spk_emb_mode='learned' (SpeakerEncoder) is queued in ROADMAP.md"
        )


def make_optimizer(config: SpeechSplitConfig, params) -> torch.optim.Adam:
    """Adam at the reference hyperparameters (main.py:42-44), moments in
    float32 (``check_precision``)."""
    check_precision(config)
    return torch.optim.Adam(
        params, lr=config.learning_rate,
        betas=(config.adam_b1, config.adam_b2), eps=ADAM_EPS,
    )


def create_train_state(
    config: SpeechSplitConfig,
    seed: int,
    model: str = "speechsplit",
    device=None,
) -> TrainState:
    """A seeded model (``"speechsplit"`` or ``"f0_converter"``) on
    ``device`` (``cuda`` unless told otherwise), its optimizer, and the
    resampling generator seeded from ``seed``."""
    dev = resolve_device(device)
    classes = {"speechsplit": SpeechSplit, "f0_converter": F0Converter}
    if model not in classes:
        raise ValueError(f"unknown model {model!r}")
    init = torch.Generator().manual_seed(seed)
    module = classes[model](config, generator=init).to(dev).train()
    return TrainState(
        model=module,
        optimizer=make_optimizer(config, module.parameters()),
        step=0,
        generator=torch.Generator().manual_seed(seed + 1),
    )


def _upcast_batch(batch: Batch, device) -> Batch:
    """The batch as float32 tensors on ``device`` (numpy or tensors in;
    ``len_org`` as int64)."""
    def move(x, dtype):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    return Batch(
        mel=move(batch.mel, torch.float32),
        spk_emb=move(batch.spk_emb, torch.float32),
        f0=move(batch.f0, torch.float32),
        len_org=move(batch.len_org, torch.int64),
    )


def _augment_inputs(config: SpeechSplitConfig, batch: Batch,
                    generator: torch.Generator) -> torch.Tensor:
    """Steps 1-3 of the reference hot loop (solver.py:160-163)."""
    x_f0 = torch.cat([batch.mel, batch.f0], dim=-1)  # [B, T, 81]
    x_f0 = random_resample(
        x_f0, batch.len_org, generator,
        min_len_seg=config.min_len_seg,
        max_len_seg=config.max_len_seg,
        max_len_seq=config.max_len_seq,
        max_len_pad=config.max_len_pad,
    )
    onehot = quantize_f0_onehot(x_f0[:, :, -1], config.dim_f0 - 1)
    return torch.cat([x_f0[:, :, :-1], onehot], dim=-1)


def generator_loss(config: SpeechSplitConfig, model: SpeechSplit,
                   batch: Batch, generator: torch.Generator) -> torch.Tensor:
    """Mean-MSE identity loss of one batch (already on the model's
    device), augmentation draws first, then the model's."""
    x_in = _augment_inputs(config, batch, generator)
    mel_out = model(x_in, batch.mel, batch.spk_emb, train=True,
                    generator=generator)
    return torch.mean(torch.square(batch.mel - mel_out))


def f0_loss(config: SpeechSplitConfig, model: F0Converter, batch: Batch,
            generator: torch.Generator) -> torch.Tensor:
    """Cross-entropy of the predicted contour against the quantized
    source contour, masked past ``len_org`` (JAX train_step.py:358-381).

    A contour value of about 1.002 or more quantizes past the last class;
    as optax's out-of-range gather, that frame's loss is NaN, and so is
    the masked sum (NaN x 0 = NaN), where ``F.cross_entropy`` would raise.
    In range, the values are ``F.cross_entropy``'s bit for bit."""
    f0 = batch.f0[:, :, 0]  # [B, T] normalized, -1e10 padded
    target_ids = quantize_f0(f0, config.dim_f0 - 1)
    f0_onehot = quantize_f0_onehot(f0, config.dim_f0 - 1)
    logits = model(batch.mel, f0_onehot, train=True, generator=generator)
    log_probs = F.log_softmax(logits.transpose(1, 2), dim=1)  # [B, C, T]
    top = log_probs.shape[1] - 1
    picked = log_probs.gather(1, target_ids.clamp(0, top)[:, None, :])
    losses = torch.where(target_ids > top, torch.nan,
                         -picked[:, 0, :])  # [B, T]
    t = losses.shape[1]
    valid = (torch.arange(t, device=losses.device)[None, :]
             < batch.len_org[:, None]).to(losses.dtype)
    return torch.sum(losses * valid) / torch.clamp(torch.sum(valid), min=1.0)


def _make_step(config: SpeechSplitConfig, loss_fn):
    check_precision(config)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        device = next(state.model.parameters()).device
        batch = _upcast_batch(batch, device)
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(config, state.model, batch, state.generator)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_train_step(
    config: SpeechSplitConfig,
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """The generator train step: ``step(state, batch) -> (state, loss)``
    runs augmentation, forward, backward and Adam, updating ``state`` in
    place; ``loss`` stays on the device. After it, each parameter's
    ``.grad`` holds that step's gradient. PyTorch runs eagerly, so this
    one factory stands for both the JAX package's jitted
    ``make_train_step`` and its raw ``make_train_step_fn``."""
    return _make_step(config, generator_loss)


def make_f0_train_step(
    config: SpeechSplitConfig,
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """The F0-converter train step, as :func:`make_train_step` (the JAX
    package's ``make_f0_train_step`` and ``make_f0_train_step_fn``)."""
    return _make_step(config, f0_loss)
