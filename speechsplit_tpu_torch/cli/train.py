"""Training CLI of the port (counterpart of speechsplit_tpu/cli/train.py).

The JAX package's flag surface (the reference's main.py:41-59 plus
``--model``, ``--hparams`` and the rest), and ``--device``:

    python -m speechsplit_tpu_torch.cli.train --num_iters 1000 \\
        --hparams "root_dir=spmel,feat_dir=raptf0"

The JAX README's recommended run (the features on the card, 10 steps a
call, bfloat16 compute at B32), and the same straight from a wav tree:

    python -m speechsplit_tpu_torch.cli.train --data_on_device \\
        --steps_per_dispatch 10 \\
        --hparams "root_dir=spmel,feat_dir=raptf0,batch_size=32,compute_dtype=bfloat16"
    python -m speechsplit_tpu_torch.cli.train --wav_dir wavs \\
        --data_on_device --steps_per_dispatch 10 \\
        --hparams "batch_size=32,compute_dtype=bfloat16"

Runs on ``cuda`` unless ``--device cpu`` is given. The default config
trains as it stands: bfloat16 residuals and Adam mu, float32 gradients,
TF32 matmuls and convolutions (``matmul_precision="default"``);
``--hparams`` sets any of them (``residual_dtype=float32,
adam_mu_dtype=float32,matmul_precision=highest`` trains in float32
throughout); ``compute_dtype=bfloat16`` trains at bfloat16 compute on
the default route; ``spk_emb_mode=learned[,spk_contrast_weight=0.1]``
trains the generator with a learned speaker encoder (zero-shot timbre
codes).

``--num_devices N`` trains data-parallel over N ranks, as JAX's spans a
data mesh; 0 means every visible card (one process with ``--device
cpu``). N > 1 spawns N ranks, one a card under NCCL, or with ``--device
cpu`` N processes under gloo; under torchrun each process joins
torchrun's world instead (N 0 or its ``WORLD_SIZE``). The global batch
is ``batch_size``, split over the ranks; rank 0 writes the checkpoints
and logs, and the run follows one process's trajectory at that batch:

    python -m speechsplit_tpu_torch.cli.train --num_devices 2 \\
        --hparams "root_dir=spmel,feat_dir=raptf0"
    torchrun --nproc_per_node 2 -m speechsplit_tpu_torch.cli.train \\
        --hparams "root_dir=spmel,feat_dir=raptf0"
"""

from __future__ import annotations

import argparse
import os
import sys


def str2bool(v: str) -> bool:
    return v.lower() in ("true", "1", "yes")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--num_iters", type=int, default=1_000_000)
    parser.add_argument("--g_lr", type=float, default=1e-4)
    parser.add_argument("--beta1", type=float, default=0.9)
    parser.add_argument("--beta2", type=float, default=0.999)
    parser.add_argument("--resume_iters", type=int, default=None)
    parser.add_argument("--use_tensorboard", type=str2bool, default=False)
    parser.add_argument("--log_dir", default="run/logs")
    parser.add_argument("--model_save_dir", default="run/models")
    parser.add_argument("--sample_dir", default="run/samples")
    parser.add_argument("--log_step", type=int, default=10)
    parser.add_argument("--sample_step", type=int, default=1000)
    parser.add_argument("--model_save_step", type=int, default=1000)
    parser.add_argument("--validation_path", default="assets/demo.pkl")
    parser.add_argument("--model", default="speechsplit",
                        choices=["speechsplit", "f0_converter"])
    parser.add_argument("--hparams", default="", help="k=v,k=v overrides")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--compress_transfers", action="store_true",
        help="send features host->device as bfloat16 (half the bytes)")
    parser.add_argument(
        "--keep_checkpoints", type=int, default=0,
        help="retain only the newest N checkpoints (0 = keep all, "
        "matching the reference)")
    parser.add_argument(
        "--profile_dir", default="",
        help="write a torch.profiler chrome trace of a few steps here")
    parser.add_argument(
        "--lazy_data", action="store_true",
        help="read features from disk on access instead of caching them "
        "in RAM")
    parser.add_argument(
        "--num_devices", type=int, default=0,
        help="ranks in the data mesh, one a card (0 = every visible card; "
        "one process with --device cpu)")
    parser.add_argument(
        "--steps_per_dispatch", type=int, default=1,
        help="stage N batches per transfer and run them as one call of "
        "the train step; must divide the log/save/sample cadences. "
        "Identical training trajectory")
    parser.add_argument(
        "--data_on_device", action="store_true",
        help="upload ALL features to the card once and collate there; "
        "the host sends only crop indices per step. Bit-identical "
        "batches to the host loader (use when the corpus fits in device "
        "memory)")
    parser.add_argument(
        "--resident_dtype", default="float32",
        choices=["float32", "bfloat16"],
        help="storage dtype for --data_on_device features (bfloat16 "
        "halves device memory at ~4e-3 feature quantization)")
    parser.add_argument(
        "--wav_dir", default="",
        help="train STRAIGHT from a wav tree: extract features on the "
        "card into the device feature store (no .npy trees, no "
        "root_dir/feat_dir needed). Requires --data_on_device. Speaker "
        "genders from --spk2gen when present")
    parser.add_argument(
        "--spk2gen", default="assets/spk2gen.pkl",
        help="speaker->gender pickle for --wav_dir (else all 'M')")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    return parser


def _env_world():
    """torchrun's ``WORLD_SIZE``, or None outside a launched world."""
    value = os.environ.get("WORLD_SIZE")
    return int(value) if value else None


def _world_size(args, env_world) -> int:
    """The ranks ``--num_devices`` asks for (JAX cli/train.py:145): 0 is
    every visible card, or one process on the CPU; in a launched world,
    0 or its size."""
    import torch

    n = args.num_devices
    if n < 0:
        raise ValueError(f"--num_devices {n}: must be 0 or more")
    if env_world is not None:
        if n not in (0, env_world):
            raise ValueError(f"--num_devices {n} in a world of {env_world} "
                             "ranks (WORLD_SIZE)")
        return env_world
    if torch.device(args.device).type != "cuda":
        return n or 1
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(f"--num_devices {n}: NCCL takes one card a rank "
                         f"and {visible} CUDA device(s) are visible")
    return n or max(visible, 1)


def _read_spk2gen(path: str, wav_dir: str) -> dict:
    """Speaker genders for ``--wav_dir`` (JAX cli/train.py:120-128): the
    pickle at ``path`` when it exists (unpickling runs code: load only
    files this project wrote), every other speaker directory "M"."""
    import pickle

    spk2gen = {}
    if os.path.exists(path):
        with open(path, "rb") as handle:
            spk2gen = dict(pickle.load(handle))
    for s in sorted(os.listdir(wav_dir)):
        if os.path.isdir(os.path.join(wav_dir, s)):
            spk2gen.setdefault(s, "M")
    return spk2gen


def main(argv=None):
    """Train; returns the final ``TrainState`` (rank 0's in a launched
    world). With ``--num_devices`` above 1 outside one, it spawns the
    ranks, waits for them and returns None: rank 0 wrote the
    checkpoints."""
    args = _parser().parse_args(argv)
    env_world = _env_world()
    world = _world_size(args, env_world)
    if world > 1 and env_world is None:
        from speechsplit_tpu_torch.parallel import launch

        if args.device.startswith("cuda"):
            from speechsplit_tpu_torch.ops import _build

            _build.build_all()  # once, before the ranks load the kernels
        launch(_rank_main, world, (sys.argv[1:] if argv is None else argv,),
               device=args.device)
        return None
    return _train(args, world)


def _rank_main(argv) -> None:
    """One spawned rank of ``main``."""
    _train(_parser().parse_args(argv), _env_world())


def _train(args, world: int):
    from speechsplit_tpu_torch import resolve_device
    from speechsplit_tpu_torch.config import SpeechSplitConfig, resolve_dtype
    from speechsplit_tpu_torch.data.dataset import SpeakerDataset
    from speechsplit_tpu_torch.data.loader import data_loader
    from speechsplit_tpu_torch.parallel import (
        initialize,
        is_primary,
        make_mesh,
    )
    from speechsplit_tpu_torch.training.solver import Solver, SolverConfig
    from speechsplit_tpu_torch.training.train_step import check_precision

    config = SpeechSplitConfig(
        learning_rate=args.g_lr, adam_b1=args.beta1, adam_b2=args.beta2
    ).parse(args.hparams)
    check_precision(config)
    device, mesh = resolve_device(args.device), None
    if world > 1:
        device = initialize(device=device)
        mesh = make_mesh((world,))
        if config.mesh_shape == (1,):
            config = config.replace(mesh_shape=(world,))
    if is_primary():
        print(config)
        for d in (args.log_dir, args.model_save_dir, args.sample_dir):
            os.makedirs(d, exist_ok=True)

    dataset = loader = resident = None
    if args.wav_dir:
        if not args.data_on_device:
            raise SystemExit("--wav_dir requires --data_on_device")
        from speechsplit_tpu_torch.data.resident import (
            build_resident_from_wavs,
        )

        resident = build_resident_from_wavs(
            args.wav_dir, _read_spk2gen(args.spk2gen, args.wav_dir), config,
            store_dtype=resolve_dtype(args.resident_dtype), seed=args.seed,
            device=device)
    else:
        dataset = SpeakerDataset(config.root_dir, config.feat_dir,
                                 mode=config.mode, eager=not args.lazy_data)
        loader = data_loader(dataset, config, seed=args.seed)
    run_config = SolverConfig(
        num_iters=args.num_iters,
        resume_iters=args.resume_iters,
        log_dir=args.log_dir,
        model_save_dir=args.model_save_dir,
        sample_dir=args.sample_dir,
        log_step=args.log_step,
        sample_step=args.sample_step,
        model_save_step=args.model_save_step,
        use_tensorboard=args.use_tensorboard,
        seed=args.seed,
        validation_path=args.validation_path,
        model=args.model,
        compress_transfers=args.compress_transfers,
        keep_checkpoints=args.keep_checkpoints,
        profile_dir=args.profile_dir,
        steps_per_dispatch=args.steps_per_dispatch,
        data_on_device=args.data_on_device,
        resident_dtype=args.resident_dtype,
    )
    return Solver(loader, run_config, config, dataset=dataset,
                  resident=resident, device=device, mesh=mesh).train()


if __name__ == "__main__":
    main()
