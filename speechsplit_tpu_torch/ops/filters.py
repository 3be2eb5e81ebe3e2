"""IIR filtering: the 30 Hz Butterworth high-pass, its zero-phase
realizations and the scan oracles (counterpart of
speechsplit_tpu/ops/filters.py; reference utils.py:10-14,
make_spect_f0.py:17,54).

The coefficients are designed on the host with scipy, as in JAX. Three
ways to apply the filter:

- the production path applies its |H(w)|^2 on the STFT bins
  (``preprocess._stft_bin_gain``, ``extract_features(highpass_mode=
  "stft")``);
- :func:`zero_phase_highpass`, the waveform high-pass of
  ``highpass_mode="time"``: the filter's |H(w)|^2 on one padded rfft of
  each odd-extended signal, in ``torch.fft`` on the tensor's device (JAX
  leaves it to XLA's FFT too);
- the sample-by-sample oracles with scipy's semantics (odd extension,
  steady-state initial conditions): :func:`sosfilt` (second-order
  sections, stable in float32) and :func:`lfilter` (the (b, a) form,
  float64 only in practice: this high-pass NaNs in float32), each pass
  of :func:`sosfiltfilt`, :func:`filtfilt` and :func:`highpass_filtfilt`.

The two recurrences run in ``csrc/iir.cu`` on CUDA tensors (a thread a
signal, one launch a pass; two launches a zero-phase call) and as their
plain versions, the sample loop in PyTorch vectorised over signals, on
CPU tensors; the kernel equals the plain loop bit for bit. Leading
dimensions of ``x`` stand in for JAX's ``vmap``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
from scipy import signal as sp_signal

from speechsplit_tpu_torch.ops import _build

# kernel launches since the last reset; the main path's proof that it ran
LAUNCHES = {"sosfilt": 0, "lfilter": 0}
# the most sections (sosfilt) and the highest order (lfilter) the kernel
# unrolls: its template instances
MAX_SECTIONS = _build.source_constant("iir", "kMaxSections")
MAX_ORDER = _build.source_constant("iir", "kMaxOrder")
_DTYPES = {torch.float32: 0, torch.float64: 1}


def butter_highpass(cutoff: float, fs: float,
                    order: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Design a Butterworth high-pass, (b, a) form (ref: utils.py:10-14)."""
    nyq = 0.5 * fs
    b, a = sp_signal.butter(order, cutoff / nyq, btype="high", analog=False)
    return b.astype(np.float64), a.astype(np.float64)


def butter_highpass_sos(cutoff: float, fs: float,
                        order: int = 5) -> np.ndarray:
    """Same filter as second-order sections ``[n_sections, 6]``."""
    nyq = 0.5 * fs
    return sp_signal.butter(order, cutoff / nyq, btype="high", analog=False,
                            output="sos")


# the recurrences -----------------------------------------------------------


def _coefficients(c, dtype: torch.dtype, device) -> torch.Tensor:
    """Coefficients as a tensor of the signal's dtype (JAX casts them to
    ``x.dtype``, filters.py:98, :141)."""
    if isinstance(c, torch.Tensor):
        return c.to(device=device, dtype=dtype)
    # a copy: scipy may hand back a view with negative strides
    return torch.from_numpy(np.array(c, np.float64)).to(device=device,
                                                         dtype=dtype)


def _host64(c) -> np.ndarray:
    """Coefficients as a contiguous float64 host array for the kernel,
    which casts them to the signal's dtype as a tensor cast rounds."""
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().double().numpy()
    return np.ascontiguousarray(c, np.float64)


def sosfilt_reference(sos: torch.Tensor, x: torch.Tensor,
                      zi: torch.Tensor) -> torch.Tensor:
    """The plain version of the cascade: sos [S, 6] of x's dtype, x [M, N],
    zi [M, S, 2] -> y [M, N]; JAX's step (filters.py:59-68) a sample, in
    its order of operations, for every signal at once."""
    n_sections = sos.shape[0]
    b, a = sos[:, :3], sos[:, 4:6]
    z = [[zi[:, s, 0], zi[:, s, 1]] for s in range(n_sections)]
    out = []
    for t in range(x.shape[-1]):
        cur = x[:, t]
        for s in range(n_sections):
            y = b[s, 0] * cur + z[s][0]
            z0 = b[s, 1] * cur + z[s][1] - a[s, 0] * y
            z1 = b[s, 2] * cur - a[s, 1] * y
            z[s] = [z0, z1]
            cur = y
        out.append(cur)
    return torch.stack(out, dim=-1)


def lfilter_reference(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
                      zi: torch.Tensor) -> torch.Tensor:
    """The plain version of the direct form: b, a [n + 1] of x's dtype,
    x [M, N], zi [M, n] -> y [M, N]; JAX's step (filters.py:108-115) a
    sample, its concatenated zero an addition of 0 here too."""
    order = a.shape[0] - 1
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    z = [zi[:, i] for i in range(order)]
    out = []
    for t in range(x.shape[-1]):
        xt = x[:, t]
        yt = b[0] * xt + z[0]
        z = [b[i + 1] * xt + (z[i + 1] if i + 1 < order else zero)
             - a[i + 1] * yt for i in range(order)]
        out.append(yt)
    return torch.stack(out, dim=-1)


def _check(what: str, x: torch.Tensor, zi: torch.Tensor) -> None:
    """The kernel's inputs: float32 or float64, one dtype, on one device."""
    if x.dtype not in _DTYPES or zi.dtype != x.dtype:
        raise ValueError(f"{what} takes float32 or float64 signals and "
                         f"states of one dtype: got {x.dtype}, {zi.dtype}")
    if zi.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, zi on {zi.device}")


def _library() -> ctypes.CDLL:
    lib = _build.load("iir")
    # x, y, zi, sos, sections, M, N, dtype, device, stream
    lib.iir_sosfilt_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.iir_sosfilt_launch.restype = ctypes.c_int
    # x, y, zi, b, a, order, M, N, dtype, device, stream
    lib.iir_lfilter_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
        + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.iir_lfilter_launch.restype = ctypes.c_int
    # sink, M, steps, dtype, stream
    lib.iir_floor_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.iir_floor_launch.restype = ctypes.c_int
    lib.iir_error_string.argtypes = [ctypes.c_int]
    lib.iir_error_string.restype = ctypes.c_char_p
    return lib


def _host_pointer(arr: np.ndarray) -> int:
    return arr.ctypes.data_as(ctypes.c_void_p).value


def sosfilt_cuda(sos, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/iir.cu``'s cascade: sos [S, 6] (host values), x
    [M, N] and zi [M, S, 2] CUDA tensors of one float dtype."""
    _check("sosfilt", x, zi)
    coefs = _host64(sos)
    n_sections = coefs.shape[0]
    if coefs.shape != (n_sections, 6) or not 1 <= n_sections <= MAX_SECTIONS:
        raise ValueError(f"sosfilt's kernel takes [S, 6] sections, S in "
                         f"1..{MAX_SECTIONS}: got {coefs.shape}")
    if x.dim() != 2 or zi.shape != (x.shape[0], n_sections, 2):
        raise ValueError(f"sosfilt's kernel takes x [M, N] and zi [M, S, 2]: "
                         f"got {tuple(x.shape)}, {tuple(zi.shape)}")
    x, zi = x.contiguous(), zi.contiguous()
    y = torch.empty_like(x)
    lib = _library()
    err = lib.iir_sosfilt_launch(
        x.data_ptr(), y.data_ptr(), zi.data_ptr(), _host_pointer(coefs),
        n_sections, x.shape[0], x.shape[1], _DTYPES[x.dtype],
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sosfilt", lib.iir_error_string)
    LAUNCHES["sosfilt"] += 1
    return y


def lfilter_cuda(b, a, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/iir.cu``'s direct form: b, a [n + 1] (host values),
    x [M, N] and zi [M, n] CUDA tensors of one float dtype."""
    _check("lfilter", x, zi)
    b64, a64 = _host64(b), _host64(a)
    order = a64.shape[0] - 1
    if b64.shape != a64.shape or not 1 <= order <= MAX_ORDER:
        raise ValueError(f"lfilter's kernel takes b and a of one length n + 1, "
                         f"n in 1..{MAX_ORDER}: got {b64.shape}, {a64.shape}")
    if x.dim() != 2 or zi.shape != (x.shape[0], order):
        raise ValueError(f"lfilter's kernel takes x [M, N] and zi [M, n]: got "
                         f"{tuple(x.shape)}, {tuple(zi.shape)}")
    x, zi = x.contiguous(), zi.contiguous()
    y = torch.empty_like(x)
    lib = _library()
    err = lib.iir_lfilter_launch(
        x.data_ptr(), y.data_ptr(), zi.data_ptr(), _host_pointer(b64),
        _host_pointer(a64), order, x.shape[0], x.shape[1], _DTYPES[x.dtype],
        x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "lfilter", lib.iir_error_string)
    LAUNCHES["lfilter"] += 1
    return y


def _device_type(what: str, x: torch.Tensor, zi: torch.Tensor) -> str:
    devices = {x.device.type, zi.device.type}
    if devices in ({"cuda"}, {"cpu"}):
        return devices.pop()
    raise ValueError(f"{what}: tensors on {sorted(devices)}")


def _flat(what: str, x: torch.Tensor, zi: torch.Tensor, state_shape: tuple):
    """x [..., N] -> [M, N] and zi [..., *state_shape] (a state a signal)
    -> [M, *state_shape]."""
    want = (*x.shape[:-1], *state_shape)
    if tuple(zi.shape) != want:
        raise ValueError(f"{what} takes zi {want} for x {tuple(x.shape)}: "
                         f"got {tuple(zi.shape)}")
    return x.reshape(-1, x.shape[-1]), zi.reshape(-1, *state_shape)


def sosfilt(sos, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Cascaded-biquad IIR along the last axis (filters.py:48-71): sos
    [S, 6] (a0 normalized to 1; numpy or a tensor), x [..., N], zi
    [..., S, 2] each signal's initial states. The kernel on CUDA tensors,
    the plain loop on CPU tensors; float32 or float64."""
    n_sections = len(sos)
    kind = _device_type("sosfilt", x, zi)
    flat_x, flat_zi = _flat("sosfilt", x, zi, (n_sections, 2))
    if kind == "cuda":
        y = sosfilt_cuda(sos, flat_x, flat_zi)
    else:
        y = sosfilt_reference(_coefficients(sos, x.dtype, x.device), flat_x,
                              flat_zi)
    return y.reshape(x.shape)


def lfilter(b, a, x: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """Direct-form II transposed IIR along the last axis (filters.py:104-
    119; float64 in practice, the (b, a) realization of steep high-passes
    NaNs in float32): b, a [n + 1] of one length, x [..., N], zi [..., n]
    each signal's initial states. The kernel on CUDA tensors, the plain
    loop on CPU tensors."""
    order = len(a) - 1
    if len(b) != len(a):
        raise ValueError(f"lfilter takes b and a of one length: got "
                         f"{len(b)}, {len(a)}")
    kind = _device_type("lfilter", x, zi)
    flat_x, flat_zi = _flat("lfilter", x, zi, (order,))
    if kind == "cuda":
        y = lfilter_cuda(b, a, flat_x, flat_zi)
    else:
        y = lfilter_reference(_coefficients(b, x.dtype, x.device),
                              _coefficients(a, x.dtype, x.device), flat_x,
                              flat_zi)
    return y.reshape(x.shape)


def _odd_extension(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """scipy's padtype='odd' (filters.py:77-79)."""
    if x.shape[-1] <= padlen:
        raise ValueError(f"the signal's length {x.shape[-1]} must exceed "
                         f"padlen {padlen}")
    left = 2.0 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
    right = 2.0 * x[..., -1:] - x[..., -padlen - 1 : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def _filtfilt(run, zi: torch.Tensor, x: torch.Tensor,
              padlen: int) -> torch.Tensor:
    """Both passes around ``run(x, zi)`` (filters.py:75-85, :121-130):
    steady-state states scaled by each pass's first sample, the reversal
    between the passes."""
    ext = _odd_extension(x, padlen)
    y = run(ext, zi * _first(ext, zi.dim()))
    y = y.flip(-1)
    y = run(y, zi * _first(y, zi.dim()))
    y = y.flip(-1)
    return y[..., padlen : padlen + x.shape[-1]]


def _first(x: torch.Tensor, state_dims: int) -> torch.Tensor:
    """x's first sample a signal, shaped to scale states of
    ``state_dims`` dimensions: [..., 1, ...]."""
    return x[..., 0].reshape(*x.shape[:-1], *(1,) * state_dims)


def sosfiltfilt(sos, x: torch.Tensor, padlen: int | None = None
                ) -> torch.Tensor:
    """Zero-phase filtering with scipy's defaults (filters.py:88-98):
    x [..., N] float32 or float64; two :func:`sosfilt` passes."""
    sos = np.asarray(sos, np.float64)
    if padlen is None:
        # scipy sosfiltfilt default: ntaps shrinks by trailing zero coeffs
        padlen = 3 * (2 * sos.shape[0] + 1 - min(
            int((sos[:, 2] == 0).sum()), int((sos[:, 5] == 0).sum())))
    zi = _coefficients(sp_signal.sosfilt_zi(sos), x.dtype, x.device)
    return _filtfilt(lambda v, z: sosfilt(sos, v, z), zi, x, padlen)


def filtfilt(b, a, x: torch.Tensor, padlen: int | None = None
             ) -> torch.Tensor:
    """scipy.signal.filtfilt semantics, (b, a) realization
    (filters.py:133-142); two :func:`lfilter` passes."""
    if padlen is None:
        padlen = 3 * max(len(a), len(b))
    zi = _coefficients(sp_signal.lfilter_zi(b, a), x.dtype, x.device)
    return _filtfilt(lambda v, z: lfilter(b, a, v, z), zi, x, padlen)


def highpass_filtfilt(x: torch.Tensor, cutoff: float = 30.0,
                      fs: float = 16000.0, order: int = 5) -> torch.Tensor:
    """The reference's zero-phase high-pass (make_spect_f0.py:17,54),
    realized stably in float32 through second-order sections; serial over
    samples (prefer :func:`zero_phase_highpass`)."""
    return sosfiltfilt(butter_highpass_sos(cutoff, fs, order), x)


# the waveform high-pass -----------------------------------------------------
#
# filtfilt applies |H(w)|^2 with zero phase: one rfft/irfft pair of an
# odd extension padded past the filter's settle time (filters.py:155-163).


@functools.lru_cache(maxsize=8)
def _zero_phase_response(cutoff: float, fs: float, order: int,
                         n: int) -> np.ndarray:
    b, a = butter_highpass(cutoff, fs, order)
    freqs = np.fft.rfftfreq(n) * 2.0 * np.pi
    _, h = sp_signal.freqz(b, a, worN=freqs)
    return (h * np.conj(h)).real.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _zero_phase_tensor(cutoff: float, fs: float, order: int, n: int,
                       device: torch.device) -> torch.Tensor:
    """:func:`_zero_phase_response` on ``device``, uploaded once a process."""
    return torch.from_numpy(_zero_phase_response(cutoff, fs, order, n)).to(
        device)


def zero_phase_highpass(
    x: torch.Tensor,
    lengths: torch.Tensor,
    *,
    cutoff: float = 30.0,
    fs: float = 16000.0,
    order: int = 5,
    pad: int = 8192,
) -> torch.Tensor:
    """Batched zero-phase Butterworth high-pass through one rfft
    (filters.py:176-227), on x's device.

    x: [B, N] zero-padded signals; lengths: [B] true lengths (>= 2),
    samples past each are ignored and zeroed in the output. pad: the odd
    extension's length; 8192 samples at 16 kHz cover the 30 Hz filter's
    impulse-response decay (pole radius^8192 about 3e-5). Returns [B, N].
    """
    batch, n_in = x.shape
    device = x.device
    n = 1 << (n_in + 2 * pad - 1).bit_length()
    h2 = _zero_phase_tensor(cutoff, fs, order, n, device)

    lengths = lengths.to(device=device, dtype=torch.int64)
    last = lengths[:, None] - 1  # [B, 1]
    j = (torch.arange(n, device=device) - pad)[None, :]  # ext-relative

    left = j < 0
    right = j > last
    src = torch.where(left, -j, torch.where(right, 2 * last - j, j))
    src_c = src.clamp(0, n_in - 1)
    vals = torch.gather(x, 1, src_c)

    x0 = x[:, :1]
    x_last = torch.gather(x, 1, last)
    anchor = torch.where(left, x0, x_last)
    zero = torch.zeros((), dtype=x.dtype, device=device)
    ext = torch.where(left | right, 2.0 * anchor - vals, vals)
    # one reflection span on each side; zeros elsewhere, so that nothing
    # rides the circular convolution
    in_span = ((j > -(last + 1)) & (j < 2 * last + 1) & (src >= 0)
               & (src <= last))
    ext = torch.where(in_span, ext, zero)

    spec = torch.fft.rfft(ext, n=n, dim=1)
    y = torch.fft.irfft(spec * h2[None, :], n=n, dim=1)
    y = y[:, pad : pad + n_in]
    frame_ix = torch.arange(n_in, device=device)[None, :]
    return torch.where(frame_ix < lengths[:, None], y, zero).to(x.dtype)
