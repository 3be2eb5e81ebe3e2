"""The port's filters (``ops/filters.py``) against the JAX package's: the
coefficient design, the scan oracles (``sosfilt``, ``lfilter`` and the
zero-phase ``sosfiltfilt``, ``filtfilt``, ``highpass_filtfilt``) at
float32 and float64 on a batch, which the port takes directly and JAX
through ``vmap``, and the FFT high-pass ``zero_phase_highpass``.

The tolerances: both packages take each step in JAX's order of
operations, but XLA's CPU code contracts some multiply-adds into FMAs
and the port's plain loop (and its kernel, which equals the loop bit for
bit) rounds every product and sum. This 30 Hz / 16 kHz high-pass is
ill-conditioned (pole radius about 0.9987), so such roundings drift:
about 1e-13 at float64, and at float32 as far as the float32 recurrence
is from the float64 result. So float64 is held within ``F64_TOL``, and
float32 within 4 times JAX's own float32 distance from the float64
result on the same inputs. The CUDA kernel is held to the plain loop on
the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sp_signal

from speechsplit_tpu.ops import filters as jfilters
from speechsplit_tpu_torch.ops import _build, filters

# float64: the FMA contractions' drift is about 2e-13 on signals of
# amplitude 0.5 through the sections; through the (b, a) form about 5e-7,
# held to JAX's own bar against scipy (tests/test_dsp.py:124)
F64_TOL = 1e-10
BA_F64_TOL = 1e-5
FLOAT32_TIMES = 4.0
BATCH, N = 3, 1500
SOS = jfilters.butter_highpass_sos(30.0, 16000.0, 5)
B, A = jfilters.butter_highpass(30.0, 16000.0, 5)
# the (b, a) form at float32: a stable low-pass (the high-pass NaNs)
B_LOW, A_LOW = sp_signal.butter(2, 0.1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain loops are many tiny ops a sample; with torch's intra-op
    threads contending with other test processes for the cores they run
    many times slower. One thread changes no value."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _signals(seed=0, n=N):
    return np.random.RandomState(seed).randn(BATCH, n) * 0.5


def _jax(fn, *args):
    """``fn`` vmapped over the batch, with float64 on."""
    with jax.enable_x64(True):
        return np.asarray(fn(*args))


def _hold(got, want, truth, dtype):
    """float64: within F64_TOL; float32: within FLOAT32_TIMES JAX's own
    distance from the float64 ``truth``."""
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=F64_TOL)
    else:
        bar = FLOAT32_TIMES * float(np.abs(want - truth).max())
        assert 0 < bar < 5e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=bar)


@pytest.mark.parametrize("cutoff, fs, order", [(30.0, 16000.0, 5),
                                               (60.0, 22050.0, 4),
                                               (100.0, 16000.0, 8)])
def test_coefficients_equal_jax(cutoff, fs, order):
    np.testing.assert_array_equal(
        filters.butter_highpass_sos(cutoff, fs, order),
        jfilters.butter_highpass_sos(cutoff, fs, order))
    for got, want in zip(filters.butter_highpass(cutoff, fs, order),
                         jfilters.butter_highpass(cutoff, fs, order)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sosfilt_equals_jax(dtype):
    x = _signals(1)
    # steady-state states for each signal's first sample (the zero-phase
    # oracles' start), scaled a signal
    scale = np.random.RandomState(2).uniform(0.5, 1.5, (BATCH, 1, 1))
    zi = sp_signal.sosfilt_zi(SOS)[None] * x[:, :1, None] * scale
    got = filters.sosfilt(SOS, torch.from_numpy(x.astype(dtype)),
                          torch.from_numpy(zi.astype(dtype))).numpy()
    want = _jax(jax.vmap(lambda v, z: jfilters.sosfilt(
        jnp.asarray(SOS, dtype), v, z)), x.astype(dtype), zi.astype(dtype))
    truth = sp_signal.sosfilt(SOS, x, zi=zi.transpose(1, 0, 2))[0]
    assert got.dtype == dtype and got.shape == (BATCH, N)
    _hold(got, want, truth, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lfilter_equals_jax(dtype):
    """float64 on the high-pass, float32 on a stable low-pass."""
    b, a = (B, A) if dtype == np.float64 else (B_LOW, A_LOW)
    x = _signals(3)
    scale = np.random.RandomState(4).uniform(0.5, 1.5, (BATCH, 1))
    zi = sp_signal.lfilter_zi(b, a)[None] * x[:, :1] * scale
    got = filters.lfilter(b, a, torch.from_numpy(x.astype(dtype)),
                          torch.from_numpy(zi.astype(dtype))).numpy()
    want = _jax(jax.vmap(lambda v, z: jfilters.lfilter(
        jnp.asarray(b, dtype), jnp.asarray(a, dtype), v, z)),
        x.astype(dtype), zi.astype(dtype))
    truth = np.stack([sp_signal.lfilter(b, a, x[i], zi=zi[i])[0]
                      for i in range(BATCH)])
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=BA_F64_TOL)
        # the port's loop rounds as scipy's does
        np.testing.assert_allclose(got, truth, rtol=0, atol=1e-12)
    else:
        _hold(got, want, truth, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sosfiltfilt_equals_jax(dtype):
    x = _signals(5)
    got = filters.sosfiltfilt(SOS, torch.from_numpy(x.astype(dtype)))
    want = _jax(jax.vmap(lambda v: jfilters.sosfiltfilt(SOS, v)),
                x.astype(dtype))
    assert got.dtype == torch.from_numpy(x.astype(dtype)).dtype
    _hold(got.numpy(), want, sp_signal.sosfiltfilt(SOS, x), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_filtfilt_equals_jax(dtype):
    """The (b, a) high-pass at float64 (JAX's and scipy's), the stable
    low-pass at float32."""
    b, a = (B, A) if dtype == np.float64 else (B_LOW, A_LOW)
    x = _signals(6)
    got = filters.filtfilt(b, a, torch.from_numpy(x.astype(dtype))).numpy()
    want = _jax(jax.vmap(lambda v: jfilters.filtfilt(b, a, v)),
                x.astype(dtype))
    truth = sp_signal.filtfilt(b, a, x)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=0, atol=BA_F64_TOL)
        np.testing.assert_allclose(got, truth, rtol=0, atol=1e-12)
    else:
        _hold(got, want, truth, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_highpass_filtfilt_equals_jax(dtype):
    x = _signals(7)[:2]
    got = filters.highpass_filtfilt(torch.from_numpy(x.astype(dtype)))
    want = _jax(jax.vmap(jfilters.highpass_filtfilt), x.astype(dtype))
    _hold(got.numpy(), want, sp_signal.sosfiltfilt(SOS, x), dtype)


def test_leading_dims():
    """x [..., N] with zi [..., S, 2] takes any leading dims: the same as
    each signal alone; a state shape that is not a state a signal
    raises."""
    x = torch.from_numpy(_signals(8, 200)).reshape(3, 1, 200)
    zi = torch.from_numpy(np.random.RandomState(9).randn(3, 1, len(SOS), 2))
    got = filters.sosfilt(SOS, x, zi)
    assert got.shape == (3, 1, 200)
    for i in range(3):
        one = filters.sosfilt(SOS, x[i, 0], zi[i, 0])
        np.testing.assert_array_equal(got[i, 0].numpy(), one.numpy())
    with pytest.raises(ValueError, match="zi"):
        filters.sosfilt(SOS, x, zi[0, 0])


@pytest.mark.parametrize("n_in, lengths", [(32768, (30000, 24000)),
                                           (5000, (5000, 2))])
def test_zero_phase_highpass_equals_jax(n_in, lengths):
    """float32 rffts of about 65,536 points in either package: within
    1e-6 of JAX's output (signals of amplitude 0.3), and zero past each
    length."""
    rng = np.random.RandomState(10)
    x = np.zeros((len(lengths), n_in), np.float32)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.randn(n) * 0.3
    lengths = np.array(lengths)
    got = filters.zero_phase_highpass(torch.from_numpy(x),
                                      torch.from_numpy(lengths)).numpy()
    want = np.asarray(jfilters.zero_phase_highpass(jnp.asarray(x),
                                                   jnp.asarray(lengths)))
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for i, n in enumerate(lengths):
        assert not got[i, n:].any()


def test_cpu_tensors_take_the_plain_loop():
    x = torch.from_numpy(_signals(11, 100))
    filters.highpass_filtfilt(x)
    filters.filtfilt(B, A, x)
    assert not any(filters.LAUNCHES.values())


def test_kernel_wrappers_raise_without_a_library(monkeypatch, tmp_path):
    """The CUDA wrappers build their library at first use; with no nvcc
    they raise instead of running the plain loop."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    x = torch.zeros(2, 16, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="nvcc"):
        filters.sosfilt_cuda(SOS, x, torch.zeros(2, len(SOS), 2,
                                                 dtype=torch.float64))
    with pytest.raises(RuntimeError, match="nvcc"):
        filters.lfilter_cuda(B, A, x, torch.zeros(2, len(A) - 1,
                                                  dtype=torch.float64))
    assert not any(filters.LAUNCHES.values())


def test_kernel_limits_are_the_source():
    assert filters.MAX_SECTIONS == 8 and filters.MAX_ORDER == 8
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="sections"):
        filters.sosfilt_cuda(np.zeros((9, 6)), x, torch.zeros(2, 9, 2))
    with pytest.raises(ValueError, match="float32 or float64"):
        filters.sosfilt_cuda(SOS, x.half(), torch.zeros(2, 3, 2).half())
    with pytest.raises(ValueError, match="one length"):
        filters.lfilter_cuda(np.ones(3), np.ones(4), x, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="padlen"):
        filters.sosfiltfilt(SOS, torch.zeros(2, 18))
