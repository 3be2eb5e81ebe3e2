"""The port's native host tracker (``ops/pitch_native.py`` over its copy
``csrc/rapt.cc``) against the JAX package's (``native/rapt.cc``): both
libraries are built here by g++ from the same source with the same
flags, so their outputs are equal bit for bit on the tones of
tests/test_pitch_native.py; and the port's native tracker against the
port's batched ``track_pitch`` at that file's cross-validation bars."""

from pathlib import Path

import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pitch_native as jnative
from speechsplit_tpu_torch.ops import _build, pitch, pitch_native

ROOT = Path(__file__).resolve().parent.parent
FS = 16000
HOP = 256


def _voiced_tone(f0, n, harmonics=4, seed=0):
    """tests/test_pitch_native.py's tone."""
    t = np.arange(n) / FS
    r = np.random.RandomState(seed)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h
              for h in range(1, harmonics + 1)) + 0.005 * r.randn(n)
    return (sig / np.abs(sig).max() * 0.5).astype(np.float32)


def test_source_is_a_copy_past_its_header():
    """The port's copy differs from native/rapt.cc by its header lines
    only (each starts with //), and JAX's build flags are the port's."""
    ours = (_build.CSRC / "rapt.cc").read_text().splitlines()
    theirs = (ROOT / "native" / "rapt.cc").read_text().splitlines()
    extra = len(ours) - len(theirs)
    assert extra > 0 and all(line.startswith("//") for line in ours[:extra])
    assert ours[extra:] == theirs
    assert pitch_native.GXX_FLAGS == ("-O3", "-march=native", "-std=c++17",
                                      "-fPIC", "-shared")


@pytest.mark.parametrize("f0, seed", [(110.0, 1), (200.0, 2), (320.0, 3),
                                      (150.0, 0)])
def test_native_equals_jax_native(f0, seed):
    x = _voiced_tone(f0, FS, seed=seed)
    got = pitch_native.track_pitch_native(x)
    want = jnative.track_pitch_native(x)
    assert got.shape == want.shape == (FS // HOP + 1,)
    np.testing.assert_array_equal(got, want)
    lo, hi = (100.0, 250.0) if f0 < 300 else (200.0, 600.0)
    np.testing.assert_array_equal(
        pitch_native.track_pitch_native(x, lo=lo, hi=hi),
        jnative.track_pitch_native(x, lo=lo, hi=hi))


def test_native_noise_unvoiced():
    x = (np.random.RandomState(0).randn(FS) * 0.3).astype(np.float32)
    out = pitch_native.track_pitch_native(x)
    np.testing.assert_array_equal(out, jnative.track_pitch_native(x))
    assert (out == pitch.UNVOICED_LOG_F0).mean() > 0.8


@pytest.mark.parametrize("f0, seed", [(110.0, 1), (200.0, 2), (320.0, 3)])
def test_native_matches_the_port_tracker(f0, seed):
    """tests/test_pitch_native.py:47-70's bars: voicing on more than 95%
    of the interior frames, a median within 10 cents where both voice."""
    x = _voiced_tone(f0, FS, seed=seed)
    native = pitch_native.track_pitch_native(x)
    device = pitch.track_pitch(
        torch.from_numpy(x[None]), torch.tensor([len(x)]),
        torch.tensor([50.0]), torch.tensor([600.0]))[0].numpy()
    assert native.shape == device.shape
    interior = slice(2, -4)
    nv = native[interior] > -1e9
    dv = device[interior] > -1e9
    assert (nv == dv).mean() > 0.95
    both = nv & dv
    cents = 1200 * np.abs(
        (native[interior][both] - device[interior][both]) / np.log(2))
    assert np.median(cents) < 10.0


def test_build_names_the_library_by_source_and_flags(monkeypatch, tmp_path):
    """A fresh build directory gets one library named by the hash, built
    in a file of this process and moved into place; a second load in the
    process reuses it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    assert pitch_native.available()
    built = sorted(p.name for p in tmp_path.iterdir())
    assert len(built) == 1 and built[0].startswith("librapt_")
    assert built[0].endswith(".so")
    pitch_native.track_pitch_native(_voiced_tone(150.0, 2048))
    assert sorted(p.name for p in tmp_path.iterdir()) == built
