"""The ranks' side of tests/test_torch_parallel.py: trajectories of the
port's train steps that a spawned gloo rank runs on its rows of a global
batch, and that one process runs on the whole batch (``mesh=None``) for
the comparison. Imports no JAX, so a spawned rank starts in seconds."""

import os

import numpy as np
import torch

from speechsplit_tpu_torch.data.collator import Batch
from speechsplit_tpu_torch.data.prefetch import stack_batches
from speechsplit_tpu_torch.parallel import make_mesh, shard_batch
from speechsplit_tpu_torch.training import (
    create_train_state,
    make_f0_train_step,
    make_train_multi_step,
    make_train_step,
)
from speechsplit_tpu_torch.training.train_step import (
    _upcast_batch,
    generator_loss,
    make_train_step_shard_map,
)


def _state(config, model, start, mesh):
    """A state at ``start``'s parameters; off rank 0 they are moved away
    first, so that only the step's broadcast from rank 0 can put them
    back."""
    state = create_train_state(config, 7, model, device="cpu")
    state.model.load_state_dict(start, strict=True)
    if mesh is not None and mesh.rank != 0:
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    return state


def _result(state, losses) -> dict:
    return dict(losses=[float(v) for v in torch.cat(
                    [torch.atleast_1d(v) for v in losses])],
                params={k: v.detach().clone()
                        for k, v in state.model.state_dict().items()},
                step=state.step)


def steps(mesh, config, model, start, batches, mode="ddp", k=1) -> dict:
    """``len(batches)`` steps from ``start`` on global numpy batches,
    each rank on its rows: ``mode`` "ddp" (``make_train_step`` or
    ``make_f0_train_step`` on the mesh), "explicit"
    (``make_train_step_shard_map``) or, with ``k`` > 1, k-step calls of
    ``make_train_multi_step`` on ``[k, B]`` stacks."""
    state = _state(config, model, start, mesh)
    if k > 1:
        step = make_train_multi_step(config, model, mesh)
        batches = list(stack_batches(iter(batches), k))
    elif mode == "explicit" and mesh is not None:
        step = make_train_step_shard_map(config, mesh)
    else:
        make = make_train_step if model == "speechsplit" else (
            make_f0_train_step)
        step = make(config, mesh)
    losses = []
    for batch in batches:
        if mesh is not None:
            batch = shard_batch(mesh, batch, axis=1 if k > 1 else 0)
        state, loss = step(state, batch)
        losses.append(loss)
    return _result(state, losses)


def reduced_grads(mesh, config, start, batch, mode="ddp") -> dict:
    """One generator step's gradients on this rank: ``local``, the
    gradients of its rows' loss alone (one-hot mode: the loss takes no
    collective) from ``start``, and ``reduced``, what the step on the
    mesh (``mode`` as in :func:`steps`) leaves in ``.grad`` after its
    all-reduce. With no mesh both are the global batch's."""
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    local = create_train_state(config, 7, "speechsplit", device="cpu")
    local.model.load_state_dict(start, strict=True)
    generator_loss(config, local.model, _upcast_batch(batch, "cpu"),
                   local.generator, mesh).backward()
    state = _state(config, "speechsplit", start, mesh)
    if mode == "explicit" and mesh is not None:
        step = make_train_step_shard_map(config, mesh)
    else:
        step = make_train_step(config, mesh)
    state, _ = step(state, batch)
    return {kind: {k: p.grad.detach().clone()
                   for k, p in model.named_parameters()}
            for kind, model in (("local", local.model),
                                ("reduced", state.model))}


def resident_steps(mesh, config, model, start, tree, calls, k=1) -> dict:
    """``calls`` calls of ``make_resident_train_step`` on the store built
    from the feature tree ``tree`` (every rank holds all of it), fed the
    global crop plans (``[k, B]`` with ``k`` > 1)."""
    from speechsplit_tpu_torch.data.dataset import SpeakerDataset
    from speechsplit_tpu_torch.data.resident import (
        build_resident,
        make_resident_train_step,
        plan_batches,
        stack_plans,
    )

    dataset = SpeakerDataset(*tree, mode=config.mode)
    features, utts = build_resident(dataset, config, device="cpu")
    plans = plan_batches(utts, features.length.numpy(), config, seed=0)
    if k > 1:
        plans = stack_plans(plans, k)
    state = _state(config, model, start, mesh)
    step = make_resident_train_step(config, features, model, mesh)
    losses = []
    for _ in range(calls):
        state, loss = step(state, next(plans))
        losses.append(loss)
    return _result(state, losses)


KINDS = {"steps": steps, "resident_steps": resident_steps,
         "reduced_grads": reduced_grads}


def run_cases(out_dir: str, cases: dict) -> None:
    """One rank: each case of ``cases`` ({name: (kind, kwargs)}) on the
    process group's mesh, the results saved as ``rank{r}.pt``."""
    mesh = make_mesh()
    results = {name: KINDS[kind](mesh, **kwargs)
               for name, (kind, kwargs) in cases.items()}
    torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def one_process(cases: dict) -> dict:
    """Every case in this process at the global batch."""
    return {name: KINDS[kind](None, **kwargs)
            for name, (kind, kwargs) in cases.items()}


def raise_on_rank_one() -> None:
    """Rank 1 raises; rank 0 waits far longer than the launch takes to
    end it (a collective here would fail as well, and either failure
    could be reported first)."""
    import time

    from speechsplit_tpu_torch import parallel

    if parallel.rank() == 1:
        raise ValueError("rank one fails")
    time.sleep(120.0)


def numpy_batch(batch) -> Batch:
    """Any package's batch as the port's ``Batch`` of numpy arrays (what
    a rank is handed: unpickling it imports nothing of JAX)."""
    return Batch(*(np.asarray(x) for x in batch))
