"""Training of the port: the train steps of both models, checkpoints in
the reference's ``.ckpt`` format, and the Solver loop."""

from speechsplit_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    f0_loss,
    generator_loss,
    make_f0_train_step,
    make_optimizer,
    make_train_multi_step,
    make_train_step,
)
from speechsplit_tpu_torch.training.solver import Solver, SolverConfig

__all__ = [
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "generator_loss",
    "f0_loss",
    "make_train_step",
    "make_f0_train_step",
    "make_train_multi_step",
    "Solver",
    "SolverConfig",
]
