"""Conversion CLI of the port (counterpart of speechsplit_tpu/cli/convert.py).

Loads generator and F0-converter weights from reference-format ``.ckpt``
files (the reference's own, or ones exported by the JAX package's
``cli.export_ckpt``), runs the requested conversion conditions between
two utterances of a demo.pkl-style bundle in one batched call, and
writes one mel ``.npy`` per condition and, with ``--synthesize``, one
PCM16 wav through the Griffin-Lim vocoder (quantized on the device):

    python -m speechsplit_tpu_torch.cli.convert \\
        --generator_ckpt 660000-G.ckpt --f0_ckpt 640000-P.ckpt \\
        --metadata demo.pkl --out_dir results --synthesize

Runs on ``cuda`` unless ``--device cpu`` is given. The neural vocoder
(``--vocoder_ckpt``, ``--vocoder_refine``) waits in ROADMAP.md A7.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


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
                        help="also write wavs (Griffin-Lim, PCM16)")
    parser.add_argument("--vocoder_ckpt", default="",
                        help="a neural vocoder (ROADMAP.md A7: refused)")
    parser.add_argument("--vocoder_refine", type=int, default=None,
                        help="the neural vocoder's refinement iterations "
                             "(ROADMAP.md A7: refused)")
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
    )
    from speechsplit_tpu_torch.interop import load_reference_checkpoint
    from speechsplit_tpu_torch.models import F0Converter, SpeechSplit

    for flag in ("vocoder_ckpt", "vocoder_refine"):
        if getattr(args, flag) not in ("", None):
            raise NotImplementedError(
                f"--{flag}: the neural vocoder is queued in ROADMAP.md A7")
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
    g_model = SpeechSplit(config)
    g_model.load_state_dict(load_reference_checkpoint(args.generator_ckpt))
    p_model = F0Converter(config)
    p_model.load_state_dict(load_reference_checkpoint(args.f0_ckpt))
    g_model = g_model.to(device).eval()
    p_model = p_model.to(device).eval()

    metadata = load_demo_metadata(args.metadata)
    src = utterance_from_metadata(config, metadata[args.source_index], device)
    trg = utterance_from_metadata(config, metadata[args.target_index], device)
    results = convert_batched(g_model, p_model, [(src, trg)], conditions,
                              compress_fetch=args.compress_results)[0]

    os.makedirs(args.out_dir, exist_ok=True)
    wavs = None
    if args.synthesize:
        from speechsplit_tpu_torch.vocoder import GriffinLimVocoder

        vocoder = GriffinLimVocoder(
            sample_rate=config.sample_rate, n_fft=config.fft_length,
            hop=config.hop_length, n_mels=config.dim_freq,
            fmin=config.mel_fmin, fmax=config.mel_fmax, device=device)
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
