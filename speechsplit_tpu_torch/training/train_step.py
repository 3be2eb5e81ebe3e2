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

In learned speaker mode (``spk_emb_mode="learned"``, JAX
train_step.py:162-270) the generator self-conditions on the batch's own
un-augmented mel through its ``SpeakerEncoder``; with
``spk_contrast_weight > 0`` the embeddings are taken once before the
forward and ``weight * speaker_contrastive_loss`` (SupCon against the
batch's speaker labels, ``argmax(batch.spk_emb)``) joins the loss.

All resampling draws of a step come from ``TrainState.generator`` (a
CPU ``torch.Generator``, see ``ops.interp``), the augmentation's before
the model's, as the JAX step splits its key. Every recurrence of the
step runs through ``ops.bilstm`` / ``ops.multi_bilstm``, whose
``autograd.Function`` launches the residual-saving forward and gradient
kernels on the card.

Precision, as the JAX step's (the defaults train as they stand):
- ``residual_dtype`` (float32 or bfloat16, default bfloat16): the dtype
  the recurrences save their residuals in (``ops.bilstm``,
  ``ops.multi_bilstm``);
- ``adam_mu_dtype`` (default bfloat16): the storage dtype of Adam's
  first moment, nu stays float32 (:class:`Adam`);
- ``grad_dtype`` (default float32): the gradients are cast to it before
  the update (``_cast_grads``);
- ``matmul_precision``: JAX's precision names on a GPU, TF32 on or off
  for cuBLAS and cuDNN over the forward and the backward
  (:func:`matmul_precision`). The recurrence kernels take exact float32
  FMAs under every setting;
- ``compute_dtype`` (default float32): the dtype the models are built
  at. With bfloat16 the products' operands are rounded to bfloat16
  (``models.layers``) and W_hh is bfloat16 in the recurrence kernels of
  the default route (``ops.bilstm``, ``ops.multi_bilstm``); the
  parameters, the Adam state and the loss stay float32.

Data-parallel training (JAX's ``mesh`` steps, train_step.py:286-498):
given a ``parallel.Mesh``, each rank runs a step on its own rows of the
global batch (``parallel.shard_batch``) and the ranks average their
gradients, through DDP (``make_train_step`` and the rest: the whole
loss runs inside DDP's forward, so the all-reduce overlaps the
backward) or one explicit all-reduce of the flattened gradients before
Adam (:func:`make_train_step_shard_map`). Rank 0's parameters are
broadcast when a step first sees a model. What makes the ranks follow
one process's trajectory at the global batch:
- the resampling draws are the global batch's on every rank, each rank
  keeping its rows (``example_ids``, ``ops.interp``);
- learned mode's contrastive term scores the global batch's embeddings
  and labels on every rank (:func:`gather_rows`, whose backward sums
  the cotangents over ranks: that x n cancels the gradient mean's / n);
- the F0 converter's masked mean is over the global count of valid
  frames (:func:`f0_loss`);
- below float32, ``grad_dtype`` casts the gradients before the
  reduction, as JAX's shard_map step does (config.py:113-114).
The loss a step returns is the global batch's, on every rank.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from speechsplit_tpu_torch import resolve_device
from speechsplit_tpu_torch.config import SpeechSplitConfig, resolve_dtype
from speechsplit_tpu_torch.data.collator import Batch
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.ops.interp import random_resample
from speechsplit_tpu_torch.ops.quantize import quantize_f0, quantize_f0_onehot
from speechsplit_tpu_torch.parallel.mesh import Mesh, replicate

# optax.adam's default epsilon (torch's Adam has the same default)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    """A model, its Adam optimizer, the step count and the CPU generator
    of the resampling draws. A step updates it in place."""

    model: torch.nn.Module
    optimizer: Adam
    step: int
    generator: torch.Generator


# JAX's matmul precision names and whether each runs float32 products in
# TF32 on a GPU that has it (jax.lax.Precision's docstring: DEFAULT and
# HIGH use tensorfloat32 on an H100, HIGHEST float32; the config's legacy
# aliases 'bfloat16', 'tensorfloat32' and 'float32' name the same three)
TF32_BY_PRECISION = {"default": True, "bfloat16": True, "high": True,
                     "tensorfloat32": True, "highest": False,
                     "float32": False}


def _tf32(name: str) -> bool:
    """Whether ``name`` runs float32 products in TF32. JAX's dot-algorithm
    presets (``"BF16_BF16_F32"``, ...) are not mapped: they raise with
    any other name."""
    if name not in TF32_BY_PRECISION:
        raise ValueError(f"matmul_precision must be one of "
                         f"{sorted(TF32_BY_PRECISION)}, got {name!r}")
    return TF32_BY_PRECISION[name]


@contextlib.contextmanager
def matmul_precision(name: str):
    """``jax.default_matmul_precision(name)`` on the card: TF32 on or off
    for cuBLAS's float32 matmuls and cuDNN's convolutions while the block
    runs (a train step's forward and ``backward()``), torch's flags
    restored after it. The recurrence kernels are exact float32 FMAs
    whatever the setting."""
    tf32 = _tf32(name)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def check_precision(config: SpeechSplitConfig) -> None:
    """Refuse settings the port has no counterpart for: compute,
    residuals, Adam mu and gradients run float32 or bfloat16 (other names
    raise ValueError); ``matmul_precision`` must be one of JAX's names."""
    for name in ("residual_dtype", "adam_mu_dtype", "grad_dtype",
                 "compute_dtype"):
        resolve_dtype(getattr(config, name))  # float32 or bfloat16
    _tf32(config.matmul_precision)


def _cast_grads(dtype: torch.dtype, grads: list) -> list:
    """The gradients narrowed to ``dtype`` (JAX ``_cast_grads``,
    train_step.py:111-122); the same tensors when they already are."""
    if all(g.dtype == dtype for g in grads):
        return grads
    return [g.to(dtype) for g in grads]


@functools.lru_cache(maxsize=None)
def _in(value: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX's weak typing applies it to an array of
    ``dtype``: rounded to that dtype first."""
    return torch.tensor(value, dtype=dtype).item()


@functools.lru_cache(maxsize=None)
def _bias(decay: float, count: int, dtype: torch.dtype) -> float:
    """optax's bias correction 1 - decay^count, in float32, then in the
    moment's dtype (``tree_bias_correction``)."""
    return _in(float(np.float32(1.0) - np.float32(decay) ** np.float32(count)),
               dtype)


def _add(a: list, b: list) -> list:
    """``a + b`` over two lists of tensors, in the promoted dtype (a
    bfloat16 term is widened to float32 when the other is float32)."""
    if a[0].dtype != b[0].dtype and a[0].dtype != torch.float32:
        a, b = b, a
    torch._foreach_add_(a, b)
    return a


class Adam(torch.optim.Optimizer):
    """Adam as optax 0.2.6's ``adam`` computes it (``scale_by_adam`` then
    the learning rate), with JAX's ``mu_dtype`` and ``grad_dtype``.

    A step: the gradients cast to ``grad_dtype``; mu = (1-b1) g + b1 mu
    and nu = (1-b2) g^2 + b2 nu, each product in its operand's dtype (a
    Python constant rounded to it first, as JAX's weak typing does: with
    a bfloat16 mu, b1 mu is a bfloat16 product before the float32 sum);
    the update -lr (mu / (1-b1^k)) / (sqrt(nu / (1-b2^k)) + eps) from that
    mu unrounded; mu stored in ``mu_dtype``, nu in float32. Where two of
    these operations are one multi-tensor op (a product added, a quotient
    scaled and added), the card may round once where optax rounds twice:
    a float32 ulp.

    optax's ``adamw`` too: ``lr`` may be a schedule, a callable of the
    count of earlier updates (optax reads its schedule at the count before
    the update, so a warmup from 0 makes the first update zero), and
    ``weight_decay`` > 0 decays every parameter in optax's order, the
    update -lr_t (adam_t + wd p), with no mask.

    The state keeps torch Adam's keys (``step``, ``exp_avg`` = mu,
    ``exp_avg_sq`` = nu), so a checkpoint of torch's Adam (the reference's
    ``.ckpt``) loads into it; mu is cast to ``mu_dtype`` on load.
    """

    def __init__(self, params, lr, betas=(0.9, 0.999),
                 eps: float = ADAM_EPS, mu_dtype=torch.float32,
                 grad_dtype=torch.float32, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype
        self.grad_dtype = grad_dtype

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.tensor(0.0)
            state["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
        return state

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for state in self.state.values():
            if "exp_avg" in state:
                state["exp_avg"] = state["exp_avg"].to(self.mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        f32 = torch.float32
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = _cast_grads(self.grad_dtype, [p.grad for p in params])
            states = [self._state(p) for p in params]
            mus = [s["exp_avg"] for s in states]
            nus = [s["exp_avg_sq"] for s in states]
            steps = [s["step"] for s in states]
            gd, md = grads[0].dtype, self.mu_dtype
            if gd == md == f32:
                # in place on the state: it is the unrounded mu
                torch._foreach_mul_(mus, _in(b1, md))
                torch._foreach_add_(mus, grads, alpha=_in(1 - b1, gd))
                mu = mus
            else:
                mu = _add(torch._foreach_mul(grads, _in(1 - b1, gd)),
                          torch._foreach_mul(mus, _in(b1, md)))
                torch._foreach_copy_(mus, mu)  # stored rounded to mu_dtype
            torch._foreach_mul_(nus, _in(b2, f32))
            if gd == f32:
                torch._foreach_addcmul_(nus, grads, grads,
                                        value=_in(1 - b2, gd))
            else:
                sq = torch._foreach_mul(grads, grads)
                torch._foreach_mul_(sq, _in(1 - b2, gd))
                _add(nus, sq)
            torch._foreach_add_(steps, 1.0)
            counts = [int(k) for k in torch.stack(steps).tolist()]
            denom = torch._foreach_div(nus, [_bias(b2, k, f32)
                                             for k in counts])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, _in(group["eps"], f32))
            mu_hat = torch._foreach_div(mu, [_bias(b1, k, mu[0].dtype)
                                             for k in counts])
            if mu_hat[0].dtype != f32:
                mu_hat = [m.float() for m in mu_hat]
            lr, wd = group["lr"], group["weight_decay"]
            if not callable(lr) and not wd:
                torch._foreach_addcdiv_(params, mu_hat, denom,
                                        value=_in(-lr, f32))
                continue
            scales = [_in(-(lr(k - 1) if callable(lr) else lr), f32)
                      for k in counts]
            update = torch._foreach_div(mu_hat, denom)
            if wd:
                torch._foreach_add_(update, params, alpha=_in(wd, f32))
            torch._foreach_mul_(update, scales)
            torch._foreach_add_(params, update)
        return None


def make_optimizer(config: SpeechSplitConfig, params) -> Adam:
    """Adam at the reference hyperparameters (main.py:42-44), mu stored in
    ``config.adam_mu_dtype`` and the gradients cast to
    ``config.grad_dtype`` (JAX ``make_optimizer`` and ``_cast_grads``)."""
    check_precision(config)
    return Adam(
        params, lr=config.learning_rate,
        betas=(config.adam_b1, config.adam_b2), eps=ADAM_EPS,
        mu_dtype=resolve_dtype(config.adam_mu_dtype),
        grad_dtype=resolve_dtype(config.grad_dtype),
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


def _rows(mesh: Optional[Mesh], batch: Batch):
    """``(example_ids, global_batch)`` of a rank's batch on ``mesh``;
    ``(None, None)`` with no mesh."""
    if mesh is None:
        return None, None
    local = batch.mel.shape[0]
    return mesh.example_ids(local), local * mesh.size


def _augment_inputs(config: SpeechSplitConfig, batch: Batch,
                    generator: torch.Generator, example_ids=None,
                    global_batch=None) -> torch.Tensor:
    """Steps 1-3 of the reference hot loop (solver.py:160-163); with
    ``example_ids`` the draws are placement-invariant (JAX
    train_step.py:136-159)."""
    x_f0 = torch.cat([batch.mel, batch.f0], dim=-1)  # [B, T, 81]
    x_f0 = random_resample(
        x_f0, batch.len_org, generator,
        min_len_seg=config.min_len_seg,
        max_len_seg=config.max_len_seg,
        max_len_seq=config.max_len_seq,
        max_len_pad=config.max_len_pad,
        example_ids=example_ids, global_batch=global_batch,
    )
    onehot = quantize_f0_onehot(x_f0[:, :, -1], config.dim_f0 - 1)
    return torch.cat([x_f0[:, :, :-1], onehot], dim=-1)


def speaker_contrastive_loss(emb: torch.Tensor, labels: torch.Tensor,
                             temp: float = 0.1) -> torch.Tensor:
    """Supervised contrastive (SupCon) loss over a batch of unit-norm
    speaker embeddings (JAX train_step.py:162-196): for each anchor with
    at least one same-label row, the mean over those positives of
    ``-log softmax(emb emb^T / temp)`` across the other rows; an anchor
    with no positive in the batch adds nothing (guarded, not NaN)."""
    emb = emb.float()
    eye = torch.eye(emb.shape[0], dtype=torch.bool, device=emb.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    sim = ((emb @ emb.t()) / temp).masked_fill(eye, -1e9)  # not self
    logp = sim - torch.logsumexp(sim, dim=1, keepdim=True)
    pos_cnt = pos.sum(dim=1)
    per_anchor = logp.masked_fill(~pos, 0.0).sum(dim=1) / torch.clamp(
        pos_cnt, min=1)
    has_pos = pos_cnt > 0
    n_anchors = torch.clamp(has_pos.sum(), min=1)
    return -per_anchor.masked_fill(~has_pos, 0.0).sum() / n_anchors


class _GatherRows(torch.autograd.Function):
    """The ranks' rows stacked in rank order (JAX's tiled
    ``all_gather``), from one all-reduce of a zero-padded buffer: gloo
    reduces CUDA tensors but does not gather them. Backward: the
    cotangent summed over the ranks (JAX's psum-scatter), this rank's
    rows of it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        b = x.shape[0]
        buf = x.new_zeros((mesh.size * b, *x.shape[1:]))
        buf[mesh.rank * b: (mesh.rank + 1) * b] = x
        return mesh.all_reduce_sum(buf)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        grad = mesh.all_reduce_sum(
            grad.clone(memory_format=torch.contiguous_format))
        b = grad.shape[0] // mesh.size
        return grad[mesh.rank * b: (mesh.rank + 1) * b], None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` [b, ...] as one [size * b, ...] tensor in rank
    order, differentiable (``dist.all_gather`` detaches)."""
    return _GatherRows.apply(x, mesh)


def _speaker_conditioning(config: SpeechSplitConfig, model: SpeechSplit,
                          batch: Batch,
                          gather_axis: Optional[Mesh] = None):
    """``(c_trg, aux_loss)`` of a generator step (JAX
    train_step.py:198-240). One-hot mode: the batch's one-hot rows and
    no auxiliary term. Learned mode: the batch's own un-augmented mel as
    a rank-3 ``c_trg`` (the model embeds it); with
    ``spk_contrast_weight > 0`` the embeddings are taken here (a rank-2
    ``c_trg``, so the encoder still runs once a step) and scored by
    :func:`speaker_contrastive_loss`.

    ``gather_axis`` (the ``parallel.Mesh`` of the process group): every
    rank scores the global batch's embeddings and labels
    (:func:`gather_rows`), as JAX's shard_map step does; with no process
    group it raises."""
    mesh = gather_axis
    if mesh is not None and not dist.is_initialized():
        raise RuntimeError("gather_axis: the mesh has no process group; "
                           "call parallel.initialize first")
    if config.spk_emb_mode != "learned":
        return batch.spk_emb, None
    if config.spk_contrast_weight <= 0.0:
        return batch.mel, None
    emb = model.embed_speaker(batch.mel)
    labels = torch.argmax(batch.spk_emb, dim=-1)
    emb_all, labels_all = emb, labels
    if mesh is not None:
        emb_all = gather_rows(emb, mesh)
        labels_all = gather_rows(labels, mesh)
    aux = config.spk_contrast_weight * speaker_contrastive_loss(
        emb_all, labels_all, config.spk_contrast_temp)
    return emb, aux


def generator_loss(config: SpeechSplitConfig, model: SpeechSplit,
                   batch: Batch, generator: torch.Generator,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean-MSE identity loss of one batch (already on the model's
    device), augmentation draws first, then the model's; in learned mode
    plus the weighted contrastive term (JAX train_step.py:255-270). On a
    ``mesh`` the batch is this rank's rows (JAX train_step.py:429-451):
    the mean is over them, as the ranks hold equal rows."""
    ids, rows = _rows(mesh, batch)
    x_in = _augment_inputs(config, batch, generator, ids, rows)
    c_trg, aux = _speaker_conditioning(config, model, batch, mesh)
    mel_out = model(x_in, batch.mel, c_trg, train=True, generator=generator,
                    example_ids=ids, global_batch=rows)
    loss = torch.mean(torch.square(batch.mel - mel_out))
    return loss if aux is None else loss + aux


def f0_loss(config: SpeechSplitConfig, model: F0Converter, batch: Batch,
            generator: torch.Generator,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Cross-entropy of the predicted contour against the quantized
    source contour, masked past ``len_org`` (JAX train_step.py:358-381).

    A contour value of about 1.002 or more quantizes past the last class;
    as optax's out-of-range gather, that frame's loss is NaN, and so is
    the masked sum (NaN x 0 = NaN), where ``F.cross_entropy`` would raise.
    In range, the values are ``F.cross_entropy``'s bit for bit.

    On a ``mesh`` (this rank's rows) the mean is the global batch's, as
    JAX's mesh step takes it: the rank's masked sum times the world over
    the global count of valid frames (one all-reduce of a scalar), so
    the gradient mean's / n leaves the global masked mean's gradient."""
    ids, rows = _rows(mesh, batch)
    f0 = batch.f0[:, :, 0]  # [B, T] normalized, -1e10 padded
    target_ids = quantize_f0(f0, config.dim_f0 - 1)
    f0_onehot = quantize_f0_onehot(f0, config.dim_f0 - 1)
    logits = model(batch.mel, f0_onehot, train=True, generator=generator,
                   example_ids=ids, global_batch=rows)
    log_probs = F.log_softmax(logits.transpose(1, 2), dim=1)  # [B, C, T]
    top = log_probs.shape[1] - 1
    picked = log_probs.gather(1, target_ids.clamp(0, top)[:, None, :])
    losses = torch.where(target_ids > top, torch.nan,
                         -picked[:, 0, :])  # [B, T]
    t = losses.shape[1]
    valid = (torch.arange(t, device=losses.device)[None, :]
             < batch.len_org[:, None]).to(losses.dtype)
    count = torch.sum(valid)
    if mesh is None:
        return torch.sum(losses * valid) / torch.clamp(count, min=1.0)
    mesh.all_reduce_sum(count)  # the global batch's valid frames
    return torch.sum(losses * valid) * mesh.size / torch.clamp(count,
                                                                min=1.0)


class _StepLoss(nn.Module):
    """A step's loss on a mesh as a module around the model, so that
    everything the loss differentiates (learned mode's ``embed_speaker``
    too) runs inside DDP's forward and its reducer sees each gradient
    once."""

    def __init__(self, config: SpeechSplitConfig, model: nn.Module, loss_fn,
                 mesh: Mesh):
        super().__init__()
        self.config, self.model, self.loss_fn, self.mesh = (
            config, model, loss_fn, mesh)

    def forward(self, batch: Batch,
                generator: torch.Generator) -> torch.Tensor:
        return self.loss_fn(self.config, self.model, batch, generator,
                            self.mesh)


def _cast_hook(dtype: torch.dtype):
    """A DDP comm hook: the bucket cast to ``dtype``, summed over the
    ranks and divided by the world in that dtype, then written back."""
    def hook(mesh: Mesh, bucket):
        buf = bucket.buffer()
        narrow = buf.to(dtype)
        fut = dist.all_reduce(narrow, async_op=True).get_future()

        def done(fut):
            return buf.copy_(fut.value()[0].div_(mesh.size))

        return fut.then(done)

    return hook


def _all_reduce_grads(mesh: Mesh, params: list, dtype: torch.dtype) -> None:
    """The explicit step's reduction (JAX train_step.py:465-469): the
    gradients cast to ``dtype``, flattened, averaged over the ranks in
    one all-reduce, and written back into each ``.grad``."""
    params = [p for p in params if p.grad is not None]
    grads = _cast_grads(dtype, [p.grad for p in params])
    flat = torch._utils._flatten_dense_tensors(grads)
    mesh.all_reduce_mean(flat)
    for p, g in zip(params,
                    torch._utils._unflatten_dense_tensors(flat, grads)):
        p.grad.copy_(g)


def _make_step(config: SpeechSplitConfig, loss_fn,
               mesh: Optional[Mesh] = None, explicit: bool = False):
    check_precision(config)
    grad_dtype = resolve_dtype(config.grad_dtype)
    held = {}  # on a mesh: the model the step last saw, what runs its loss

    def compute_for(model: nn.Module):
        if mesh is None:
            return functools.partial(loss_fn, config, model)
        if held.get("model") is not model:
            loss = _StepLoss(config, model, loss_fn, mesh)
            if explicit:
                replicate(mesh, model)
            else:
                loss = nn.parallel.DistributedDataParallel(loss)
                if grad_dtype != torch.float32:
                    loss.register_comm_hook(mesh, _cast_hook(grad_dtype))
            held.update(model=model, loss=loss)
        return held["loss"]

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        device = next(state.model.parameters()).device
        batch = _upcast_batch(batch, device)
        compute = compute_for(state.model)
        state.optimizer.zero_grad(set_to_none=True)
        # as JAX differentiates a loss traced under the precision
        with matmul_precision(config.matmul_precision):
            loss = compute(batch, state.generator)
            loss.backward()
        if mesh is not None and explicit:
            _all_reduce_grads(mesh, list(state.model.parameters()),
                              grad_dtype)
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        if mesh is not None:
            loss = mesh.all_reduce_mean(loss.clone())
        return state, loss

    return step


def make_train_step(
    config: SpeechSplitConfig,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """The generator train step: ``step(state, batch) -> (state, loss)``
    runs augmentation, forward, backward and Adam, updating ``state`` in
    place; ``loss`` stays on the device. After it, each parameter's
    ``.grad`` holds that step's gradient. PyTorch runs eagerly, so this
    one factory stands for both the JAX package's jitted
    ``make_train_step`` and its raw ``make_train_step_fn``.

    With a ``mesh`` (``parallel.make_mesh``) ``batch`` is this rank's
    rows of the global batch and the model runs under DDP, its gradients
    averaged over the ranks as the backward runs (JAX's GSPMD step);
    ``loss`` is the global batch's."""
    return _make_step(config, generator_loss, mesh)


def make_f0_train_step(
    config: SpeechSplitConfig,
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """The F0-converter train step, as :func:`make_train_step` (the JAX
    package's ``make_f0_train_step`` and ``make_f0_train_step_fn``)."""
    return _make_step(config, f0_loss, mesh)


def make_train_step_shard_map(
    config: SpeechSplitConfig,
    mesh: Mesh,
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """The generator step with its collectives spelled out (JAX
    train_step.py:405-484): each rank takes the loss and gradients of its
    rows, then the gradients, cast to ``grad_dtype``, are averaged in one
    all-reduce of their flattened values before Adam, and the loss in
    another. Rank 0's parameters are broadcast when the step first sees a
    model. Its trajectory is the DDP step's up to the order of sums."""
    return _make_step(config, generator_loss, mesh, explicit=True)


def make_train_multi_step(
    config: SpeechSplitConfig,
    model: str = "speechsplit",
    mesh: Optional[Mesh] = None,
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """K train steps a call (JAX train_step.py:297-347): ``step(state,
    batches) -> (state, losses)`` takes a batch whose fields carry a
    leading ``[k]`` axis (``data.prefetch.stack_batches``) and runs the
    generator's (``model="speechsplit"``) or the F0 converter's step on
    each slice in order; ``losses`` is a ``[k]`` tensor on the device,
    and nothing is read on the host inside the call.

    JAX scans the k steps inside one compiled program, within fusion
    noise of k single dispatches. Here the k steps are the single step's
    own calls, drawing from ``TrainState.generator`` in the same order,
    so a k-step call is k single steps bit for bit. It takes no CUDA
    graph: the resampling draws are made on the host each step
    (``ops.interp``), and that stays so the stream of draws does not
    change (ROADMAP.md B). With a ``mesh`` each slice is this rank's
    rows, as :func:`make_train_step` takes them."""
    makers = {"speechsplit": make_train_step,
              "f0_converter": make_f0_train_step}
    if model not in makers:
        raise ValueError(f"unknown model {model!r}")
    step = makers[model](config, mesh)

    def multi(state: TrainState,
              batches: Batch) -> Tuple[TrainState, torch.Tensor]:
        losses = []
        for i in range(len(batches[0])):
            state, loss = step(state, type(batches)(*(x[i] for x in batches)))
            losses.append(loss)
        return state, torch.stack(losses)

    return multi
