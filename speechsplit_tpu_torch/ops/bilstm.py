"""One bidirectional LSTM layer, both directions in one kernel launch.

Counterpart of ``speechsplit_tpu/ops/pallas_lstm.py::bilstm_sequence``
(its lean forward ``_bd_infer``). Carries the mel decoder (3 layers,
H=512), the F0 decoder (2 layers, H=256) and content-encoder layer 1
(H=8).

Layout contract: ``xp_f``, ``xp_b`` [T, B, 4H] are the projected inputs
``x W_ih^T + b_ih + b_hh`` of the forward and backward direction, both
in real time order; ``w_f``, ``w_b`` are [4H, H], torch's
``weight_hh_l{k}`` layout (the transpose of the JAX package's [H, 4H]).
Returns ``(h_f, h_b)``, each [T, B, H] in real time order.

On a CUDA tensor :func:`bilstm_sequence` launches
``csrc/bilstm_infer.cu`` or raises; on CPU tensors it runs
:func:`bilstm_sequence_reference`, the plain time loop of the same cell.
"""

from __future__ import annotations

import ctypes

import torch

from speechsplit_tpu_torch.ops import _build

# kernel launches since the last reset; the main path's proof that it ran
LAUNCHES = 0

MAX_HIDDEN = 512


def cell(xp: torch.Tensor, w: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One LSTM step (pallas_lstm._cell): xp [B, 4H], w [4H, H]."""
    gates = xp + h @ w.t()
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_direction_reference(
    xp: torch.Tensor, w: torch.Tensor, reverse: bool
) -> torch.Tensor:
    """Plain time loop of one direction; xp [T, B, 4H] in real order."""
    t_len, batch, four_h = xp.shape
    h = xp.new_zeros(batch, four_h // 4, dtype=torch.float32)
    c = torch.zeros_like(h)
    out = xp.new_empty(t_len, batch, four_h // 4, dtype=torch.float32)
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        h, c = cell(xp[t], w, h, c)
        out[t] = h
    return out


def bilstm_sequence_reference(xp_f, xp_b, w_f, w_b):
    """The plain PyTorch version of the kernel (any device)."""
    return (
        lstm_direction_reference(xp_f, w_f, reverse=False),
        lstm_direction_reference(xp_b, w_b, reverse=True),
    )


def _check(xp_f, xp_b, w_f, w_b) -> None:
    tensors = (xp_f, xp_b, w_f, w_b)
    if any(x.dtype != torch.float32 for x in tensors):
        raise NotImplementedError(
            "bilstm_sequence runs float32 only; bfloat16 compute is "
            "queued in ROADMAP.md"
        )
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("bilstm_sequence needs contiguous tensors")
    if xp_f.dim() != 3 or xp_f.shape != xp_b.shape:
        raise ValueError(
            f"xp_f/xp_b must be equal [T, B, 4H], got {tuple(xp_f.shape)} "
            f"and {tuple(xp_b.shape)}"
        )
    four_h = xp_f.shape[-1]
    if four_h % 4 or w_f.shape != (four_h, four_h // 4) or (
        w_b.shape != w_f.shape
    ):
        raise ValueError(
            f"w_f/w_b must be [4H, H] = [{four_h}, {four_h // 4}], got "
            f"{tuple(w_f.shape)} and {tuple(w_b.shape)}"
        )
    if four_h // 4 > MAX_HIDDEN:
        raise ValueError(
            f"bilstm_infer takes H <= {MAX_HIDDEN}, got {four_h // 4}"
        )


def _library():
    lib = _build.load("bilstm_infer")
    fn = lib.bilstm_infer_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    lib.bilstm_error_string.argtypes = [ctypes.c_int]
    lib.bilstm_error_string.restype = ctypes.c_char_p
    return lib


def bilstm_sequence_cuda(xp_f, xp_b, w_f, w_b):
    """Launch ``csrc/bilstm_infer.cu`` on the current stream."""
    global LAUNCHES
    _check(xp_f, xp_b, w_f, w_b)
    t_len, batch, four_h = xp_f.shape
    h_f = torch.empty(
        t_len, batch, four_h // 4, device=xp_f.device, dtype=torch.float32
    )
    h_b = torch.empty_like(h_f)
    lib = _library()
    stream = torch.cuda.current_stream(xp_f.device).cuda_stream
    err = lib.bilstm_infer_launch(
        xp_f.data_ptr(), xp_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
        h_f.data_ptr(), h_b.data_ptr(), t_len, batch, four_h // 4,
        xp_f.device.index or 0, stream,
    )
    _build.check(err, "bilstm_infer", lib.bilstm_error_string)
    LAUNCHES += 1
    return h_f, h_b


def bilstm_sequence(xp_f, xp_b, w_f, w_b):
    """Both BiLSTM directions of one layer; see the module docstring."""
    devices = {x.device.type for x in (xp_f, xp_b, w_f, w_b)}
    if devices == {"cuda"}:
        return bilstm_sequence_cuda(xp_f, xp_b, w_f, w_b)
    if devices == {"cpu"}:
        return bilstm_sequence_reference(xp_f, xp_b, w_f, w_b)
    raise ValueError(f"bilstm_sequence: tensors on {sorted(devices)}")
