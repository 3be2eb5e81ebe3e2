"""The native (C++) host pitch tracker (counterpart of
speechsplit_tpu/ops/pitch_native.py).

``csrc/rapt.cc``, the port's copy of the JAX package's ``native/rapt.cc``,
implements the tracker of :mod:`speechsplit_tpu_torch.ops.pitch` in plain
C++ on one utterance. This module builds it with ``g++`` and JAX's flags
at first use (``ops._build.load_host``: into ``_build/``, named by a hash
of the source and the flags) and exposes a numpy API.

A host path by design, as in JAX: numpy in, numpy out, for data workers
that preprocess with no accelerator. It is not a device entry point and
takes no ``device``; the card's tracker is
:func:`speechsplit_tpu_torch.ops.pitch.track_pitch`.
"""

from __future__ import annotations

import ctypes

import numpy as np

from speechsplit_tpu_torch.ops import _build

# JAX's build (pitch_native.py:29-36)
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")


def _load() -> ctypes.CDLL:
    lib = _build.load_host("rapt", GXX_FLAGS)
    lib.rapt_track.restype = ctypes.c_int
    lib.rapt_track.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # x
        ctypes.c_long,                   # n
        ctypes.c_int,                    # fs
        ctypes.c_int,                    # hop
        ctypes.c_float,                  # lo
        ctypes.c_float,                  # hi
        ctypes.POINTER(ctypes.c_float),  # out
        ctypes.c_long,                   # n_frames
    ]
    return lib


def available() -> bool:
    """Whether the library builds and loads here (g++ present)."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def track_pitch_native(
    x: np.ndarray,
    *,
    sample_rate: int = 16000,
    hop: int = 256,
    lo: float = 50.0,
    hi: float = 600.0,
) -> np.ndarray:
    """log-F0 of one waveform on the host CPU.

    x: [N] float32. Returns [N//hop + 1] natural-log F0 with -1e10 at
    unvoiced frames: the device tracker's contract and the reference's
    RAPT usage (make_spect_f0.py:64-65).
    """
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    n_frames = len(x) // hop + 1
    out = np.empty(n_frames, np.float32)
    rc = lib.rapt_track(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(len(x)),
        ctypes.c_int(sample_rate),
        ctypes.c_int(hop),
        ctypes.c_float(lo),
        ctypes.c_float(hi),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(n_frames),
    )
    if rc != 0:
        raise RuntimeError(f"rapt_track failed with code {rc}")
    return out
