"""N independent narrow BiLSTMs in one kernel launch.

Counterpart of ``speechsplit_tpu/ops/pallas_multilstm.py::
multi_bilstm_sequence`` (its lean forward ``_infer``). The generator's
encoder recurrences (content layer 0 H=8, pitch H=32, rhythm H=1) and
the F0 converter's (f0 H=32, rhythm H=1) are independent of each other
and latency-bound, so they run together.

Arguments as in the JAX op, minus its residual dtype (there is no
backward in this slice): ``multi_bilstm_sequence(n, xp_f0, xp_b0, ...,
xp_f{n-1}, xp_b{n-1}, w_f0, w_b0, ..., w_f{n-1}, w_b{n-1})`` with
``xp_*`` [T, B, 4H_s] in real time order and ``w_*`` [4H_s, H_s] in
torch's ``weight_hh_l{k}`` layout. Returns the 2n outputs
``(h_f0, h_b0, ...)``, each [T, B, H_s] in real time order.

On CUDA tensors it launches ``csrc/multi_bilstm_infer.cu`` or raises;
on CPU tensors it runs :func:`multi_bilstm_sequence_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from speechsplit_tpu_torch.ops import _build
from speechsplit_tpu_torch.ops.bilstm import lstm_direction_reference

# kernel launches since the last reset; the main path's proof that it ran
LAUNCHES = 0

MAX_DIRECTIONS = 8
MAX_HIDDEN = 64


def _split(n: int, args):
    if len(args) != 4 * n:
        raise ValueError(f"expected {4 * n} arrays for n={n}, got {len(args)}")
    return args[: 2 * n], args[2 * n :]


def multi_bilstm_sequence_reference(n: int, *args):
    """The plain PyTorch version of the kernel (any device)."""
    xps, ws = _split(n, args)
    return tuple(
        lstm_direction_reference(xp, w, reverse=bool(d % 2))
        for d, (xp, w) in enumerate(zip(xps, ws))
    )


def _check(n: int, xps, ws) -> None:
    if not 1 <= 2 * n <= MAX_DIRECTIONS:
        raise ValueError(f"multi_bilstm_infer takes 1..4 streams, got {n}")
    shape = xps[0].shape
    for xp, w in zip(xps, ws):
        if xp.dtype != torch.float32 or w.dtype != torch.float32:
            raise NotImplementedError(
                "multi_bilstm_sequence runs float32 only; bfloat16 compute "
                "is queued in ROADMAP.md"
            )
        if not (xp.is_contiguous() and w.is_contiguous()):
            raise ValueError("multi_bilstm_sequence needs contiguous tensors")
        four_h = xp.shape[-1]
        if xp.dim() != 3 or xp.shape[:2] != shape[:2] or four_h % 4:
            raise ValueError(
                f"xp must be [T, B, 4H] with a shared T and B, got "
                f"{tuple(xp.shape)} beside {tuple(shape)}"
            )
        if w.shape != (four_h, four_h // 4):
            raise ValueError(
                f"w must be [4H, H] = [{four_h}, {four_h // 4}], got "
                f"{tuple(w.shape)}"
            )
        if four_h // 4 > MAX_HIDDEN:
            raise ValueError(
                f"multi_bilstm_infer takes H <= {MAX_HIDDEN}, got {four_h // 4}"
            )


def _library():
    lib = _build.load("multi_bilstm_infer")
    fn = lib.multi_bilstm_infer_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.multi_bilstm_error_string.argtypes = [ctypes.c_int]
    lib.multi_bilstm_error_string.restype = ctypes.c_char_p
    return lib


def multi_bilstm_sequence_cuda(n: int, *args):
    """Launch ``csrc/multi_bilstm_infer.cu`` on the current stream."""
    global LAUNCHES
    xps, ws = _split(n, args)
    _check(n, xps, ws)
    t_len, batch, _ = xps[0].shape
    device = xps[0].device
    outs = tuple(
        torch.empty(t_len, batch, xp.shape[-1] // 4, device=device,
                    dtype=torch.float32)
        for xp in xps
    )
    dirs = 2 * n
    ptrs = ctypes.c_void_p * dirs
    hs = (ctypes.c_int * dirs)(*(xp.shape[-1] // 4 for xp in xps))
    lib = _library()
    err = lib.multi_bilstm_infer_launch(
        dirs,
        ptrs(*(x.data_ptr() for x in xps)),
        ptrs(*(w.data_ptr() for w in ws)),
        ptrs(*(h.data_ptr() for h in outs)),
        hs, t_len, batch, device.index or 0,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "multi_bilstm_infer", lib.multi_bilstm_error_string)
    LAUNCHES += 1
    return outs


def multi_bilstm_sequence(n: int, *args):
    """n independent BiLSTMs; see the module docstring."""
    devices = {x.device.type for x in args}
    if devices == {"cuda"}:
        return multi_bilstm_sequence_cuda(n, *args)
    if devices == {"cpu"}:
        return multi_bilstm_sequence_reference(n, *args)
    raise ValueError(f"multi_bilstm_sequence: tensors on {sorted(devices)}")
