"""Checkpoint save/restore in the reference's format (counterpart of
speechsplit_tpu/training/checkpoint.py, which writes Orbax directories).

The reference saves ``{iter}-G.ckpt`` dicts of model and optimizer state
every ``model_save_step`` iterations and restores both on
``--resume_iters`` (solver.py:84-90,198-202). Here a checkpoint is
``{model_save_dir}/{iter}-{tag}.ckpt`` (tag ``G`` for the generator,
``P`` for the F0 converter), written by ``torch.save`` as::

    {"model": state dict (the reference's names, CPU tensors),
     "optimizer": the Adam's state_dict() (torch Adam's keys, mu in
                  config.adam_mu_dtype),
     "step": int,
     "generator": TrainState.generator.get_state()}

so ``interop.load_reference_checkpoint`` and ``load_state_dict(strict=
True)`` load its model as they load a reference ``.ckpt``. The
resampling generator's state is saved because the port draws each step
from that stateful generator (the JAX package folds the step into a
fixed key): with it a resumed run continues the uninterrupted run's
draws.

On a data mesh rank 0 alone writes (``training.Solver``), and every
rank restores from the same file. What is saved is the replica itself,
never its DDP wrapper, so the names carry no ``module.`` prefix: a
``.ckpt`` from any world loads strictly into a one-process model.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from speechsplit_tpu_torch.training.train_step import TrainState


def checkpoint_path(model_save_dir: str, step: int, tag: str = "G") -> str:
    return os.path.abspath(os.path.join(model_save_dir, f"{step}-{tag}.ckpt"))


def save_checkpoint(
    model_save_dir: str, step: int, state: TrainState, tag: str = "G"
) -> str:
    """Write ``state`` as ``{step}-{tag}.ckpt``; returns the path."""
    path = checkpoint_path(model_save_dir, step, tag)
    model = {k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()}
    torch.save({
        "model": model,
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "generator": state.generator.get_state(),
    }, path)
    return path


def restore_checkpoint(
    model_save_dir: str, step: int, state: TrainState, tag: str = "G"
) -> TrainState:
    """Load ``{step}-{tag}.ckpt`` into ``state`` (in place) and return it.

    The file loads onto the CPU (``weights_only=True``); the model's
    parameters are copied into the model where it lives, and
    ``Adam.load_state_dict`` moves the Adam moments to each parameter's
    device, mu in the optimizer's ``mu_dtype`` (a bfloat16 mu round-trips
    bit for bit).
    """
    path = checkpoint_path(model_save_dir, step, tag)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator"])
    return state


def checkpoint_steps(model_save_dir: str, tag: str = "G") -> list[int]:
    """The steps of the ``{step}-{tag}.ckpt`` files, ascending."""
    if not os.path.isdir(model_save_dir):
        return []
    suffix = f"-{tag}.ckpt"
    steps = []
    for name in os.listdir(model_save_dir):
        if name.endswith(suffix):
            try:
                steps.append(int(name[: -len(suffix)]))
            except ValueError:
                continue
    return sorted(steps)


def latest_checkpoint_step(
    model_save_dir: str, tag: str = "G"
) -> Optional[int]:
    steps = checkpoint_steps(model_save_dir, tag)
    return max(steps) if steps else None


def prune_checkpoints(model_save_dir: str, keep: int, tag: str = "G") -> None:
    """Delete all but the newest ``keep`` checkpoints of ``tag`` (0 keeps
    all, as the reference does)."""
    steps = checkpoint_steps(model_save_dir, tag)
    for step in steps[:-keep] if keep > 0 else []:
        os.remove(checkpoint_path(model_save_dir, step, tag))
