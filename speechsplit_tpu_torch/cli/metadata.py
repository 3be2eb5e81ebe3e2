"""Metadata CLI of the port (counterpart of speechsplit_tpu/cli/metadata.py;
replaces the reference's make_metadata.py): walk the mel tree that
``cli.preprocess`` wrote and write its ``train.pkl``. Host work only, so
it takes no ``--device``.

    python -m speechsplit_tpu_torch.cli.metadata --mel_dir spmel
"""

from __future__ import annotations

import argparse


def main(argv=None) -> list:
    """Write ``train.pkl``; returns the metadata list."""
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mel_dir", default="assets/spmel")
    parser.add_argument("--dim_spk_emb", type=int, default=82)
    parser.add_argument(
        "--reference_compat", action="store_true",
        help="the reference's hard-coded p226/other one-hot slots "
        "(make_metadata.py:20-24)")
    args = parser.parse_args(argv)

    from speechsplit_tpu_torch.data.prepare import build_metadata

    meta = build_metadata(args.mel_dir, dim_spk_emb=args.dim_spk_emb,
                          reference_compat=args.reference_compat)
    total = sum(len(m) - 2 for m in meta)
    print(f"wrote metadata: {len(meta)} speakers, {total} utterances")
    return meta


if __name__ == "__main__":
    main()
