"""The training loop (counterpart of speechsplit_tpu/training/solver.py).

Rebuilds the reference Solver (solver.py:18-269): a train loop with
periodic logging, checkpoints, demo-set validation and 5-panel ablation
spectrogram renders, on the port's train steps and background prefetch
to the card. Also trains the F0 converter (``model="f0_converter"``).

Two of JAX's options change what a loop iteration is:
- ``steps_per_dispatch`` k > 1: k host batches stacked
  (``data.prefetch.stack_batches``) and run by ``make_train_multi_step``
  in one call; the log, checkpoint and validation cadences must fall on
  those boundaries;
- ``data_on_device``: the corpus's features live on the card
  (``data.resident``), and the loop feeds crop plans, ``[B]`` or
  ``[k, B]``, instead of batches; the plans restart from the seed on a
  resume, as the host loader does.
Either way a run is the host loader's trajectory at k = 1: the same
batches and draws, the same steps (bit for bit wherever a step repeats
bit for bit: on the CPU, and on the card at the default config).

The loss stays on the card between log steps: the loop reads it on the
host only at ``log_step``, so the loop adds no host synchronization to
a step.

On a data mesh (``mesh``, ``parallel.make_mesh``; JAX's ``mesh``
argument) every rank runs this loop: the same global loader from the
same seed, of which it keeps its rows (``parallel.shard_batch``), or
the same global crop plans, and the step on the mesh. Rank 0 alone
writes checkpoints, logs, samples and tensorboard and runs
``validate``; the ranks wait for it after each write. Every rank
restores on a resume and checks the (global) loss at a log step.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import time
from typing import Iterator, Optional

import numpy as np
import torch

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.config import SpeechSplitConfig, resolve_dtype
from speechsplit_tpu_torch.data.collator import Batch
from speechsplit_tpu_torch.data.prefetch import (
    prefetch_to_device,
    stack_batches,
)
from speechsplit_tpu_torch.ops.masks import pad_time_axis
from speechsplit_tpu_torch.ops.quantize import quantize_f0_onehot
from speechsplit_tpu_torch.parallel.distributed import barrier, is_primary
from speechsplit_tpu_torch.parallel.mesh import (
    Mesh,
    check_mesh_shape,
    shard_batch,
)
from speechsplit_tpu_torch.training import checkpoint as ckpt_lib
from speechsplit_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_f0_train_step,
    make_train_multi_step,
    make_train_step,
)
from speechsplit_tpu_torch.utils.profiling import StepTimer


@dataclasses.dataclass
class SolverConfig:
    """Run configuration (reference: main.py:41-59 argparse surface);
    the same fields as the JAX package's."""

    num_iters: int = 1_000_000
    resume_iters: Optional[int] = None
    log_dir: str = "run/logs"
    model_save_dir: str = "run/models"
    sample_dir: str = "run/samples"
    log_step: int = 10
    sample_step: int = 1000
    model_save_step: int = 1000
    use_tensorboard: bool = False
    seed: int = 0
    validation_path: str = "assets/demo.pkl"
    model: str = "speechsplit"  # or "f0_converter"
    profile_dir: str = ""       # torch.profiler trace of a step window
    profile_start: int = 10
    profile_steps: int = 5
    compress_transfers: bool = False  # bf16 host->device feature feed
    keep_checkpoints: int = 0         # 0 = keep all (reference behavior)
    # >1: this many steps a call of the train step (make_train_multi_step);
    # must divide the log, save and sample steps and num_iters
    steps_per_dispatch: int = 1
    # the features on the card, collated there from [B] crop plans
    # (data.resident); needs Solver(dataset=...) or Solver(resident=...)
    data_on_device: bool = False
    resident_dtype: str = "float32"  # or "bfloat16": half the store


def check_cadence(run_config: SolverConfig) -> None:
    """Refuse a log, save or sample step, or a run length, that falls
    inside a k-step call (JAX solver.py:169-181)."""
    k = run_config.steps_per_dispatch
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be positive, got {k}")
    for name in ("log_step", "model_save_step", "sample_step", "num_iters"):
        val = getattr(run_config, name)
        if val % k:
            raise ValueError(
                f"steps_per_dispatch={k} must divide {name}={val} so "
                "logging/checkpoint events land on dispatch boundaries")


def check_run_config(run_config: SolverConfig, config: SpeechSplitConfig,
                     mesh: Optional[Mesh] = None) -> None:
    """``config.mesh_shape`` must be ``(world,)`` over ``("data",)``, the
    world being the mesh's ranks (1 with no mesh); ``batch_size`` must
    split over them."""
    world = 1 if mesh is None else mesh.size
    check_mesh_shape(config.mesh_shape, config.mesh_axes, world)
    if config.batch_size % world:
        raise ValueError(f"batch_size={config.batch_size} does not split "
                         f"over {world} ranks")


class Solver:
    def __init__(
        self,
        loader: Optional[Iterator[Batch]],
        run_config: SolverConfig,
        config: SpeechSplitConfig,
        dataset=None,
        resident=None,
        device=None,
        mesh: Optional[Mesh] = None,
    ):
        """``loader`` yields numpy ``Batch``es (``data.data_loader``);
        ``device`` is ``cuda`` unless told otherwise. With
        ``data_on_device`` the loader is not read: the store is
        ``resident`` (``(features, speaker_utts)``, such as
        ``data.resident.build_resident_from_wavs`` returns) or is built
        from ``dataset`` at ``resident_dtype``. ``mesh``: train this
        rank's rows of each global batch with the other ranks of the
        mesh (module docstring); ``loader`` yields global batches."""
        check_run_config(run_config, config, mesh)
        check_cadence(run_config)
        if run_config.data_on_device and resident is None and dataset is None:
            raise ValueError(
                "data_on_device=True requires Solver(dataset=...) "
                "or Solver(resident=(features, speaker_utts))")
        self.loader = loader
        self.rc = run_config
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.state = create_train_state(config, run_config.seed,
                                        run_config.model, self.device)
        self.tag = "G" if run_config.model == "speechsplit" else "P"
        self._resident = None
        if run_config.data_on_device:
            # imported here: data.resident imports the training package
            from speechsplit_tpu_torch.data import resident as resident_lib

            if resident is None:
                resident = resident_lib.build_resident(
                    dataset, config,
                    store_dtype=resolve_dtype(run_config.resident_dtype),
                    device=self.device)
            self._resident = resident
            self.train_step = resident_lib.make_resident_train_step(
                config, resident[0], run_config.model, mesh)
        elif run_config.steps_per_dispatch > 1:
            self.train_step = make_train_multi_step(config, run_config.model,
                                                    mesh)
        else:
            make = (make_train_step if run_config.model == "speechsplit"
                    else make_f0_train_step)
            self.train_step = make(config, mesh)

        n_params = sum(p.numel() for p in self.state.model.parameters())
        self._print(f"{self.tag}: {n_params} parameters")

        self.writer = None
        if run_config.use_tensorboard and is_primary():
            from tensorboardX import SummaryWriter  # lazy, optional

            os.makedirs(run_config.log_dir, exist_ok=True)
            self.writer = SummaryWriter(run_config.log_dir)

        self.validation_pt = None
        if os.path.exists(run_config.validation_path):
            with open(run_config.validation_path, "rb") as handle:
                self.validation_pt = pickle.load(handle)

    @staticmethod
    def _print(text: str) -> None:
        if is_primary():
            print(text)

    # ------------------------------------------------------------------
    def train(self) -> TrainState:
        rc = self.rc
        if is_primary():
            os.makedirs(rc.model_save_dir, exist_ok=True)
            os.makedirs(rc.sample_dir, exist_ok=True)

        start_iters = 0
        num_iters = rc.num_iters
        if rc.resume_iters:
            self._print(f"Resuming from step {rc.resume_iters}...")
            start_iters = rc.resume_iters
            num_iters += rc.resume_iters  # ref: solver.py:119-120
            ckpt_lib.restore_checkpoint(
                rc.model_save_dir, rc.resume_iters, self.state, self.tag)

        k = rc.steps_per_dispatch
        if self._resident is not None:
            from speechsplit_tpu_torch.data import resident as resident_lib

            features, speaker_utts = self._resident
            loader = resident_lib.plan_batches(
                speaker_utts, features.length.cpu().numpy(), self.config,
                seed=rc.seed)
        else:
            loader = self.loader
            if self.mesh is not None:  # this rank's rows of each batch
                loader = (shard_batch(self.mesh, b) for b in loader)
        if k > 1:
            loader = stack_batches(loader, k)
        batches = prefetch_to_device(loader, device=self.device,
                                     compress=rc.compress_transfers)
        self._print("Start training...")
        start_time = time.time()
        timer = StepTimer()
        profiler, profile_end = None, None
        try:
            for i in range(start_iters, num_iters, k):
                batch = next(batches)
                if (rc.profile_dir and is_primary() and profile_end is None
                        and i >= start_iters + rc.profile_start):
                    profiler = self._start_profiler()
                    profile_end = i + rc.profile_steps
                self.state, loss = self.train_step(self.state, batch)
                timer.tick(k)
                i += k - 1  # the dispatch's last step, for the cadences
                if profiler is not None and i + 1 >= profile_end:
                    self._stop_profiler(profiler, i + 1)
                    profiler = None

                if (i + 1) % rc.log_step == 0:
                    # a k-step call's losses: the last step's is logged
                    self._log(i + 1, num_iters, float(loss.reshape(-1)[-1]),
                              timer, start_time)
                if (i + 1) % rc.model_save_step == 0:
                    if is_primary():
                        path = ckpt_lib.save_checkpoint(
                            rc.model_save_dir, i + 1, self.state, self.tag)
                        print(f"Saved checkpoint {path}")
                        if rc.keep_checkpoints:
                            ckpt_lib.prune_checkpoints(
                                rc.model_save_dir, rc.keep_checkpoints,
                                self.tag)
                    barrier()
                if ((i + 1) % rc.sample_step == 0 and self.validation_pt
                        and rc.model == "speechsplit"):
                    if is_primary():
                        val = self.validate()
                        print(f"Validation loss: {val}")
                        if self.writer:
                            self.writer.add_scalar("Validation_loss", val,
                                                   i + 1)
                        self.render_samples(i + 1)
                    barrier()
        finally:
            if profiler is not None:
                profiler.stop()
            batches.close()
        return self.state

    def _log(self, step: int, num_iters: int, loss_val: float,
             timer: StepTimer, start_time: float) -> None:
        if not np.isfinite(loss_val):
            raise FloatingPointError(
                f"non-finite loss {loss_val} at step {step}; latest "
                f"checkpoint is in {self.rc.model_save_dir}")
        et = str(datetime.timedelta(seconds=time.time() - start_time))[:-7]
        self._print(f"Elapsed [{et}], Iteration [{step}/{num_iters}], "
                    f"{self.tag}/loss_id: {loss_val:.8f}, "
                    f"{timer.steps_per_sec:.1f} steps/s")
        if self.writer:
            self.writer.add_scalar(f"{self.tag}/loss_id", loss_val, step)
            self.writer.add_scalar("steps_per_sec", timer.steps_per_sec,
                                   step)

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, step: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.rc.profile_dir, exist_ok=True)
        path = os.path.join(self.rc.profile_dir, f"trace_{step}.json")
        profiler.export_chrome_trace(path)
        print(f"Wrote profiler trace to {path}")

    # ------------------------------------------------------------------
    def _prepare_val_inputs(self, val_sub):
        """Pad one validation utterance (ref: solver.py:210-220): the
        inputs (x_f0 [1, T, 80+257], x_pad [1, T, 80], emb [1, 82]) on
        the solver's device. The contour is padded in float64 and
        quantized in float32, as the JAX package's ``jnp.asarray`` of it
        is (x64 off). In learned mode the third input is the padded mel
        itself, which the generator embeds as training does (JAX
        solver.py:289-296): the stored one-hot comes from a distribution
        a learned-mode decoder never saw."""
        cfg = self.config
        emb = np.asarray(val_sub[1], np.float32).reshape(1, -1)
        mel, f0, length, _uid = val_sub[2]
        x_pad, _ = pad_time_axis(np.asarray(mel, np.float32)[None],
                                 cfg.max_len_pad)
        f0_pad = np.pad(np.asarray(f0, np.float64),
                        (0, cfg.max_len_pad - length)).astype(np.float32)
        onehot = quantize_f0_onehot(torch.from_numpy(f0_pad),
                                    cfg.dim_f0 - 1).numpy()[None]
        x_f0 = np.concatenate([x_pad, onehot], axis=-1)
        if cfg.spk_emb_mode == "learned":
            emb = x_pad
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (x_f0, x_pad, emb))

    def _eval(self, x_f0, x_org, c_trg) -> torch.Tensor:
        return self.state.model(x_f0, x_org, c_trg, train=False)

    @torch.inference_mode()
    def validate(self) -> float:
        """Mean over the validation utterances of the sum-MSE
        reconstruction (ref: solver.py:206-225)."""
        losses = []
        for val_sub in self.validation_pt:
            x_f0, x_pad, emb = self._prepare_val_inputs(val_sub)
            out = self._eval(x_f0, x_pad, emb)
            losses.append(float(torch.sum(torch.square(x_pad - out))))
        return float(np.mean(losses))

    @torch.inference_mode()
    def render_samples(self, step: int) -> None:
        """5-panel ablation renders: GT / recon / woC / woR / woF
        (ref: solver.py:231-269), ``{sample_dir}/{step}_{speaker}_2.png``.
        Needs matplotlib, imported here only."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        dim_freq = self.config.dim_freq
        for val_sub in self.validation_pt:
            x_f0, x_pad, emb = self._prepare_val_inputs(val_sub)
            zeros_f0 = x_f0.clone()
            zeros_f0[:, :, dim_freq:] = 0.0
            zeros_mel = x_f0.clone()
            zeros_mel[:, :, :dim_freq] = 0.0

            recon = self._eval(x_f0, x_pad, emb)
            wo_f = self._eval(zeros_f0, x_pad, emb)
            wo_r = self._eval(x_f0, torch.zeros_like(x_pad), emb)
            wo_c = self._eval(zeros_mel, x_pad, emb)

            panels = [x[0].T.cpu().numpy()
                      for x in (x_pad, recon, wo_c, wo_r, wo_f)]
            vmin = min(p.min() for p in panels)
            vmax = max(p.max() for p in panels)
            fig, axes = plt.subplots(5, 1, sharex=True)
            for ax, panel in zip(axes, panels):
                ax.imshow(panel, aspect="auto", vmin=vmin, vmax=vmax)
            fig.savefig(
                os.path.join(self.rc.sample_dir, f"{step}_{val_sub[0]}_2.png"),
                dpi=150)
            plt.close(fig)
