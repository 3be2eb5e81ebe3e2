"""Train the neural (iSTFT-head) vocoder on a directory of wavs
(counterpart of speechsplit_tpu/cli/train_vocoder.py).

Mels come from the port's own front end, so training and inference see
the same normalization; the corpus stays on the card and crops are
drawn there, ``--steps_per_dispatch`` steps between two host reads of
the loss:

    python -m speechsplit_tpu_torch.cli.train_vocoder --wav_dir wavs \\
        --save_dir run/vocoder --num_iters 50000

Checkpoints are ``{iters}-V.npz`` (float32, flax's keys), which
``vocoder_neural.load_vocoder`` and ``--vocoder_ckpt`` read (the JAX
trainer writes an Orbax directory there). Runs on ``cuda`` unless
``--device cpu`` is given. A non-finite logged loss raises
``FloatingPointError``.
"""

from __future__ import annotations

import argparse
import os
import time

# the front end's wavs are zero-padded to multiples of this many seconds
BUCKET_S = 0.5
# the F0 search range of the mels' pitch tracker (Hz): both genders'
F0_RANGE = (50.0, 600.0)


def _load_corpus(wav_dir: str, limit: int | None = None):
    from speechsplit_tpu_torch.data.prepare import list_wavs, read_wav

    paths = list_wavs(wav_dir)
    if limit:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    return [read_wav(p) for p in paths]


def front_end_mels(wavs, config, device) -> list:
    """Each wav's mel [len // hop + 1, 80] from ``extract_features``: the
    wav zero-padded to a multiple of half a second, F0 range 50-600 Hz,
    the dither drawn from a generator seeded 0 for every wav (JAX reuses
    ``PRNGKey(0)``)."""
    import numpy as np
    import torch

    from speechsplit_tpu_torch.preprocess import extract_features

    bucket = int(config.sample_rate * BUCKET_S)
    mels = []
    for w in wavs:
        n_pad = -(-len(w) // bucket) * bucket
        w_pad = np.zeros((1, n_pad), np.float32)
        w_pad[0, : len(w)] = w
        mel, _f0 = extract_features(
            w_pad, [len(w)], [F0_RANGE[0]], [F0_RANGE[1]], device=device,
            generator=torch.Generator(device=device).manual_seed(0))
        mels.append(mel[0, : len(w) // config.hop_length + 1].cpu().numpy())
    return mels


def main(argv=None):
    """Train; returns ``(state, logged)``: the final ``VocoderState`` and
    the ``(iteration, mean loss of the dispatch)`` pairs logged."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--wav_dir", required=True)
    ap.add_argument("--save_dir", default="run/vocoder")
    ap.add_argument("--num_iters", type=int, default=50_000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--crop_frames", type=int, default=64)
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--learning_rate", type=float, default=2e-4)
    ap.add_argument(
        "--cosine_decay", action=argparse.BooleanOptionalAction,
        default=True,
        help="warmup + cosine lr decay over --num_iters (default on)")
    ap.add_argument("--log_step", type=int, default=100)
    ap.add_argument("--save_step", type=int, default=5000)
    ap.add_argument(
        "--steps_per_dispatch", type=int, default=25,
        help="steps between two host reads of the loss (the corpus is on "
        "the card and crops are drawn there)")
    ap.add_argument("--max_files", type=int, default=0,
                    help="cap corpus size (0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    import math

    import torch

    from speechsplit_tpu_torch import resolve_device
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.vocoder_neural import (
        ResidentCorpus,
        VocoderTrainer,
        save_vocoder,
    )

    device = resolve_device(args.device)
    config = SpeechSplitConfig()
    wavs = _load_corpus(args.wav_dir, args.max_files or None)
    print(f"corpus: {len(wavs)} wavs")
    mels = front_end_mels(wavs, config, device)
    print("front-end mels computed", flush=True)

    trainer = VocoderTrainer(
        n_fft=config.fft_length, hop=config.hop_length,
        channels=args.channels, depth=args.depth,
        learning_rate=args.learning_rate, sample_rate=config.sample_rate,
        n_mels=config.dim_freq, fmin=config.mel_fmin, fmax=config.mel_fmax,
        total_steps=args.num_iters if args.cosine_decay else 0,
        device=device)
    state = trainer.init(args.seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"V: {n_params} parameters")

    k = max(1, args.steps_per_dispatch)
    corpus = ResidentCorpus(wavs, mels, args.crop_frames, trainer.hop,
                            device)
    dispatch = trainer.make_resident_step(corpus, args.batch_size, k)
    print(f"corpus resident: {corpus.wavs.numel() * 4 / 1e6:.0f} MB wav + "
          f"{corpus.mels.numel() * 4 / 1e6:.0f} MB mel on {device}, {k} "
          "steps a dispatch", flush=True)

    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    os.makedirs(args.save_dir, exist_ok=True)
    start = time.time()
    done = 0
    logged = []
    while done < args.num_iters:
        state, loss = dispatch(state, generator)
        done += k
        if done % max(args.log_step, k) < k:
            loss_val = float(loss)
            if not math.isfinite(loss_val):
                raise FloatingPointError(f"loss {loss_val} at {done}")
            logged.append((done, loss_val))
            rate = done / (time.time() - start)
            print(f"iter {done}/{args.num_iters} loss {loss_val:.4f} "
                  f"({rate:.1f} steps/s)", flush=True)
        if done % args.save_step < k or done >= args.num_iters:
            path = save_vocoder(os.path.join(args.save_dir, f"{done}-V"),
                                state.model)
            print(f"saved {path}", flush=True)
    return state, logged


if __name__ == "__main__":
    main()
