"""Typed configuration for the PyTorch port.

Field for field the same dataclass as the JAX package's
``speechsplit_tpu.config.SpeechSplitConfig``: same names, same defaults,
same ``parse("k=v,...")`` grammar (reference: hparams.py:7-43,
tfcompat/hparam.py:523-544). The port keeps its own copy so that it
imports nothing of the JAX package; ``tests/test_torch_imports.py``
holds the two field sets equal. Dtype strings resolve to torch dtypes.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class SpeechSplitConfig:
    # --- model bottlenecks (reference: hparams.py:9-18) -------------------
    freq: int = 8          # content code downsample stride
    dim_neck: int = 8      # content bottleneck width (per direction)
    dim_enc: int = 512     # content conv-stack channels
    freq_2: int = 8
    dim_neck_2: int = 1
    dim_enc_2: int = 128
    freq_3: int = 8
    dim_neck_3: int = 32
    dim_enc_3: int = 256

    # --- feature geometry (reference: hparams.py:20-25) -------------------
    dim_freq: int = 80        # mel bins
    dim_spk_emb: int = 82     # speaker one-hot / embedding size
    dim_f0: int = 257         # quantized log-F0 bins (256 + unvoiced)
    chs_grp: int = 16         # channels per GroupNorm group

    # --- random-resampling augmentation (reference: hparams.py:27-32) -----
    min_len_seg: int = 19
    max_len_seg: int = 32
    min_len_seq: int = 64
    max_len_seq: int = 128
    max_len_pad: int = 192

    # --- decoder widths (reference: model.py:244-247, 268-271) ------------
    dim_dec_mel: int = 512
    dim_dec_f0: int = 256

    # --- audio front-end (reference: make_spect_f0.py:15-17, utils.py:18) -
    sample_rate: int = 16000
    fft_length: int = 1024
    hop_length: int = 256
    mel_fmin: float = 90.0
    mel_fmax: float = 7600.0
    highpass_cutoff_hz: float = 30.0
    highpass_order: int = 5
    ref_level_db: float = 16.0
    min_level_db: float = -100.0

    # --- data pipeline (reference: hparams.py:34-42) ----------------------
    root_dir: str = "assets/spmel"
    feat_dir: str = "assets/raptf0"
    wav_dir: str = "assets/wavs"
    batch_size: int = 16
    mode: str = "train"
    shuffle: bool = True
    n_repeats: int = 8        # reference: `samplier` (sic), hparams.py:41

    # --- training (reference: main.py:41-44) -------------------------------
    learning_rate: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999

    # --- precision and layout knobs (no reference counterpart) -------------
    # The defaults are the JAX package's and train as they stand (bfloat16
    # residuals and Adam mu); "bfloat16" compute runs on every route (the
    # default, the fused and the single-direction ones) at every
    # bottleneck width.
    compute_dtype: str = "float32"
    residual_dtype: str = "bfloat16"
    matmul_precision: str = "default"
    adam_mu_dtype: str = "bfloat16"
    grad_dtype: str = "float32"
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    spk_emb_mode: str = "onehot"
    dim_spk_enc: int = 256
    spk_contrast_weight: float = 0.0
    spk_contrast_temp: float = 0.1

    # ------------------------------------------------------------------ api
    @property
    def dim_code(self) -> int:
        """Concatenated decoder-input width (reference: model.py:244)."""
        return (
            2 * self.dim_neck
            + 2 * self.dim_neck_2
            + 2 * self.dim_neck_3
            + self.dim_spk_emb
        )

    _ALIASES = {
        "samplier": "n_repeats",       # reference typo, hparams.py:41
        "num_workers": None,           # meaningless here; accepted+ignored
        "dim_dec": "dim_dec_mel",      # reference dead key, hparams.py:23
        "len_raw": None,               # reference dead key, hparams.py:24
    }

    def parse(self, spec: str) -> "SpeechSplitConfig":
        """Apply ``"key=value,key=value"`` overrides, HParams.parse-style.

        Values are Python literals when they parse as such, else strings;
        commas inside brackets or quotes do not split. Unknown keys raise
        ``ValueError``; reference-era aliases are translated.
        """
        if not spec:
            return self
        names = {f.name for f in dataclasses.fields(self)}
        updates: dict[str, Any] = {}
        for item in _split_overrides(spec):
            if not item.strip():
                continue
            if "=" not in item:
                raise ValueError(f"malformed override {item!r}; expected k=v")
            key, value = item.split("=", 1)
            key = key.strip()
            if key in self._ALIASES:
                key = self._ALIASES[key]
                if key is None:
                    continue
            if key not in names:
                raise ValueError(f"unknown config key {key!r}")
            try:
                parsed = ast.literal_eval(value.strip())
            except (ValueError, SyntaxError):
                parsed = value.strip()
            if isinstance(parsed, list) and isinstance(
                getattr(self, key), tuple
            ):
                parsed = tuple(parsed)
            updates[key] = parsed
        return dataclasses.replace(self, **updates)

    def replace(self, **kwargs: Any) -> "SpeechSplitConfig":
        return dataclasses.replace(self, **kwargs)


def _split_overrides(spec: str) -> list[str]:
    """Split ``"a=1,b=[2,3],c='x,y'"`` on top-level commas only."""
    items: list[str] = []
    depth = 0
    quote: str | None = None
    start = 0
    for i, ch in enumerate(spec):
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth = max(0, depth - 1)
        elif ch == "," and depth == 0:
            items.append(spec[start:i])
            start = i + 1
    items.append(spec[start:])
    return items


def resolve_dtype(name: str) -> torch.dtype:
    """Map a dtype config string to a torch dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"dtype must be one of {sorted(table)}, got {name!r}")
    return table[name]


def default_config() -> SpeechSplitConfig:
    return SpeechSplitConfig()
