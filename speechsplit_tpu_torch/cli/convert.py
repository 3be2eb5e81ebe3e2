"""Conversion CLI of the port (counterpart of speechsplit_tpu/cli/convert.py).

Loads generator and F0-converter weights from reference-format ``.ckpt``
files (the reference's own, or ones exported by the JAX package's
``cli.export_ckpt``), runs the requested conversion conditions between
two utterances of a demo.pkl-style bundle in one batched call, and
writes one mel ``.npy`` per condition and, with ``--synthesize``, one
PCM16 wav (quantized on the device) through the Griffin-Lim vocoder, or
the neural one with ``--vocoder_ckpt`` (a packed ``.npz``, or
``default`` for the shipped asset; ``--vocoder_refine`` iterations,
default 48):

    python -m speechsplit_tpu_torch.cli.convert \\
        --generator_ckpt 660000-G.ckpt --f0_ckpt 640000-P.ckpt \\
        --metadata demo.pkl --out_dir results --synthesize

Runs on ``cuda`` unless ``--device cpu`` is given. A learned-mode
generator (``--hparams spk_emb_mode=learned``) takes both utterances'
timbre codes from their own mels (``convert.with_learned_embedding``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _vocoder(args, config, device):
    """The neural vocoder ``--vocoder_ckpt`` names, else Griffin-Lim."""
    if args.vocoder_ckpt:
        from speechsplit_tpu_torch.vocoder_neural import load_vocoder

        return load_vocoder(
            args.vocoder_ckpt, hop=config.hop_length,
            sample_rate=config.sample_rate, refine_iters=args.vocoder_refine,
            device=device)
    from speechsplit_tpu_torch.vocoder import GriffinLimVocoder

    return GriffinLimVocoder(
        sample_rate=config.sample_rate, n_fft=config.fft_length,
        hop=config.hop_length, n_mels=config.dim_freq, fmin=config.mel_fmin,
        fmax=config.mel_fmax, device=device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--generator_ckpt", required=True,
                        help="generator weights, a reference-format .ckpt")
    parser.add_argument("--f0_ckpt", required=True,
                        help="F0-converter weights, a reference-format .ckpt")
    parser.add_argument("--metadata", default="assets/demo.pkl")
    parser.add_argument("--source_index", type=int, default=0)
    parser.add_argument("--target_index", type=int, default=1)
    parser.add_argument("--out_dir", default="results")
    parser.add_argument(
        "--conditions", default="R,F,U,RF,RU,FU,RFU",
        help="comma-separated subset of the 7 conditions",
    )
    parser.add_argument("--synthesize", action="store_true",
                        help="also write wavs (PCM16)")
    parser.add_argument("--vocoder_ckpt", default="",
                        help="a neural vocoder: a packed .npz, or 'default' "
                             "for the shipped assets/vocoder_istft_100k.npz; "
                             "empty = Griffin-Lim")
    parser.add_argument("--vocoder_refine", type=int, default=48,
                        help="mel-consistency iterations on the neural "
                             "vocoder's spectrum (0 = the head alone)")
    parser.add_argument(
        "--compress_results", action="store_true",
        help="fetch the result mels as bfloat16 (half the bytes; about "
             "2e-3 of rounding on the [0, 1] scale)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    parser.add_argument("--hparams", default="", help="k=v,k=v overrides")
    args = parser.parse_args(argv)

    from speechsplit_tpu_torch import resolve_device
    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.convert import (
        CONDITIONS,
        convert_batched,
        load_demo_metadata,
        utterance_from_metadata,
        with_learned_embedding,
    )
    from speechsplit_tpu_torch.interop import load_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    conditions = args.conditions.split(",")
    unknown = sorted(set(conditions) - set(CONDITIONS))
    if unknown:
        parser.error(f"unknown conditions {unknown}; choose from {CONDITIONS}")
    for path in (args.generator_ckpt, args.f0_ckpt):
        if not path.endswith(".ckpt"):
            parser.error(
                f"{path}: only reference-format .ckpt files load here; "
                "Orbax checkpoint directories are queued in ROADMAP.md"
            )
    device = resolve_device(args.device)
    config = SpeechSplitConfig().parse(args.hparams)
    # the vocoder first: a checkpoint it cannot read fails before the work
    vocoder = _vocoder(args, config, device) if args.synthesize else None
    g_model = SpeechSplit(config)
    g_model.load_state_dict(load_reference_checkpoint(args.generator_ckpt))
    p_model = F0Converter(config)
    p_model.load_state_dict(load_reference_checkpoint(args.f0_ckpt))
    g_model = g_model.to(device).eval()
    p_model = p_model.to(device).eval()

    metadata = load_demo_metadata(args.metadata)
    src = utterance_from_metadata(config, metadata[args.source_index], device)
    trg = utterance_from_metadata(config, metadata[args.target_index], device)
    # learned-mode checkpoints: zero-shot timbre targets from the
    # utterances' own mels (a no-op for one-hot configs)
    src = with_learned_embedding(config, g_model, src)
    trg = with_learned_embedding(config, g_model, trg)
    results = convert_batched(g_model, p_model, [(src, trg)], conditions,
                              compress_fetch=args.compress_results)[0]

    os.makedirs(args.out_dir, exist_ok=True)
    wavs = None
    if vocoder is not None:
        wavs = vocoder.synthesize_batch([mel for _, mel in results],
                                        pcm16=True)
    for i, (name, mel) in enumerate(results):
        np.save(os.path.join(args.out_dir, name + ".npy"), mel)
        print(f"{name}: mel {mel.shape}")
        if wavs is not None:
            from scipy.io import wavfile

            wavfile.write(os.path.join(args.out_dir, name + ".wav"),
                          vocoder.sample_rate, wavs[i])


if __name__ == "__main__":
    main()
