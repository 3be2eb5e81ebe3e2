"""Conversion server of the port (counterpart of
speechsplit_tpu/cli/serve.py): load the models once, serve conversions
over HTTP (stdlib ``http.server``) through
:class:`speechsplit_tpu_torch.pipeline.VoiceConverter`.

    python -m speechsplit_tpu_torch.cli.serve \\
        --generator_ckpt 660000-G.ckpt --f0_ckpt 640000-P.ckpt

API (JSON over POST), the JAX server's:
  POST /convert
    {"source_wav": "<path>", "target_wav": "<path>",
     "conditions": ["RFU", ...],          # optional, default all 7
     "src_gender": "M", "trg_gender": "F",  # optional
     "out_dir": "<path>",                  # optional
     "synthesize": true,                   # optional, default true
     "compress_results": "auto"}           # optional
  -> {"results": {"RFU": {"mel_shape": [T, 80],
                          "wav_path": "...", "mel_path": "..."}}}
  A missing field or file is 400, an unknown endpoint 404, any other
  failure 500.

  GET /health -> {"status": "ok", "device": "<card name>" or "cpu"}

Single-threaded: one card, one stream of work. Runs on ``cuda`` unless
``--device cpu`` is given. Griffin-Lim is the vocoder unless
``--vocoder_ckpt`` names a neural one (a packed ``.npz``, or ``default``
for the shipped ``assets/vocoder_istft_100k.npz``), refined by
``--vocoder_refine`` mel-consistency iterations (default 48). A
learned-mode generator (``--hparams spk_emb_mode=learned``) converts
zero-shot: each wav's timbre target comes from its own mel.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer


def device_name(device) -> str:
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def build_handler(converter, default_out: str):
    import numpy as np
    from scipy.io import wavfile

    from speechsplit_tpu_torch.convert import CONDITIONS

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet default logging
            pass

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok",
                                  "device": device_name(converter.device)})
            else:
                self._reply(404, {"error": "unknown endpoint"})

        def do_POST(self):
            if self.path != "/convert":
                self._reply(404, {"error": "unknown endpoint"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                src = req["source_wav"]
                trg = req["target_wav"]
            except (KeyError, json.JSONDecodeError) as exc:
                self._reply(400, {"error": f"bad request: {exc!r}; need "
                                           "source_wav and target_wav"})
                return
            try:
                out_dir = req.get("out_dir", default_out)
                os.makedirs(out_dir, exist_ok=True)
                results = converter.convert_wav_files(
                    src, trg,
                    src_gender=req.get("src_gender", "M"),
                    trg_gender=req.get("trg_gender", "F"),
                    conditions=tuple(req.get("conditions", CONDITIONS)),
                    synthesize=bool(req.get("synthesize", True)),
                    compress_results=req.get("compress_results", "auto"),
                    # written as PCM16 below: quantized on the device
                    pcm16=True,
                )
                stem = os.path.splitext(os.path.basename(src))[0]
                payload = {}
                for condition, entry in results.items():
                    mel_path = os.path.join(out_dir, f"{stem}_{condition}.npy")
                    np.save(mel_path, entry["mel"])
                    info = {"mel_shape": list(entry["mel"].shape),
                            "mel_path": mel_path}
                    if "wav" in entry:
                        wav_path = os.path.join(out_dir,
                                                f"{stem}_{condition}.wav")
                        wav = entry["wav"]
                        if wav.dtype != np.int16:  # a float vocoder's
                            wav = (wav * 32767).astype(np.int16)
                        wavfile.write(wav_path, converter.config.sample_rate,
                                      wav)
                        info["wav_path"] = wav_path
                    payload[condition] = info
                self._reply(200, {"results": payload})
            except FileNotFoundError as exc:
                self._reply(400, {"error": str(exc)})
            except Exception as exc:  # the real error, to the caller
                traceback.print_exc()
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--generator_ckpt", required=True,
                        help="generator weights, a reference-format .ckpt")
    parser.add_argument("--f0_ckpt", required=True,
                        help="F0-converter weights, a reference-format .ckpt")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8571)
    parser.add_argument("--out_dir", default="results")
    parser.add_argument("--vocoder_ckpt", default="",
                        help="a neural vocoder: a packed .npz, or 'default' "
                             "for the shipped assets/vocoder_istft_100k.npz; "
                             "empty = Griffin-Lim")
    parser.add_argument("--vocoder_refine", type=int, default=48,
                        help="mel-consistency iterations on the neural "
                             "vocoder's spectrum (0 = the head alone)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    parser.add_argument("--hparams", default="", help="k=v,k=v overrides")
    args = parser.parse_args(argv)

    from speechsplit_tpu_torch.config import SpeechSplitConfig
    from speechsplit_tpu_torch.pipeline import VoiceConverter

    config = SpeechSplitConfig().parse(args.hparams)
    vocoder = None
    if args.vocoder_ckpt:
        from speechsplit_tpu_torch.vocoder_neural import load_vocoder

        vocoder = load_vocoder(
            args.vocoder_ckpt, hop=config.hop_length,
            sample_rate=config.sample_rate, refine_iters=args.vocoder_refine,
            device=args.device)
    converter = VoiceConverter.from_checkpoints(
        args.generator_ckpt, args.f0_ckpt, config=config, vocoder=vocoder,
        device=args.device)
    server = HTTPServer((args.host, args.port),
                        build_handler(converter, args.out_dir))
    print(f"serving on http://{args.host}:{server.server_port} "
          f"({device_name(converter.device)})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
