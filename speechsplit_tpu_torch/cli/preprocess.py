"""Preprocessing CLI of the port (counterpart of
speechsplit_tpu/cli/preprocess.py; replaces the reference's
make_spect_f0.py).

Walks ``--wav_dir/<speaker>/*.wav``, extracts mel and normalized F0 on
the card in batches (``data.prepare.extract_dir``) and writes the
parallel ``.npy`` trees that ``cli.metadata`` and ``cli.train`` read.
Speaker genders come from a ``spk2gen.pkl`` mapping (the reference's
format, make_spect_f0.py:19) or default to ``--default_gender``:

    python -m speechsplit_tpu_torch.cli.preprocess --wav_dir wavs \\
        --mel_dir spmel --f0_dir raptf0 --spk2gen spk2gen.pkl

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time


def main(argv=None) -> list:
    """Extract the corpus; returns the speakers processed."""
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--wav_dir", default="assets/wavs")
    parser.add_argument("--mel_dir", default="assets/spmel")
    parser.add_argument("--f0_dir", default="assets/raptf0")
    parser.add_argument("--spk2gen", default="assets/spk2gen.pkl")
    parser.add_argument("--default_gender", default="M", choices="MF")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--batches_per_dispatch", type=int, default=8,
        help="same-shape wav batches grouped into one extraction call; "
        "one group is computed while the previous one is fetched")
    parser.add_argument(
        "--compress_fetch", action="store_true",
        help="fetch features from the card as bfloat16 (half the "
        "device->host bytes; the .npy files stay float32)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    args = parser.parse_args(argv)

    from speechsplit_tpu_torch import resolve_device
    from speechsplit_tpu_torch.data.prepare import extract_dir

    device = resolve_device(args.device)
    if os.path.exists(args.spk2gen):
        with open(args.spk2gen, "rb") as handle:
            spk2gen = pickle.load(handle)
    else:
        print(f"no {args.spk2gen}; defaulting gender {args.default_gender}")
        spk2gen = {}
    for s in sorted(d for d in os.listdir(args.wav_dir)
                    if os.path.isdir(os.path.join(args.wav_dir, d))):
        spk2gen.setdefault(s, args.default_gender)

    start = time.time()
    done = extract_dir(
        args.wav_dir, args.mel_dir, args.f0_dir, spk2gen,
        batch_size=args.batch_size, seed=args.seed,
        batches_per_dispatch=args.batches_per_dispatch,
        compress_fetch=args.compress_fetch, device=device)
    print(f"processed {len(done)} speakers in {time.time() - start:.1f}s")
    return done


if __name__ == "__main__":
    main()
