"""One direction of an LSTM layer in one kernel launch.

Counterpart of ``speechsplit_tpu/ops/pallas_lstm.py::lstm_sequence`` and
its custom VJP (pallas_lstm.py:487-567): the lean forward ``_infer``, the
residual-saving forward ``_fwd`` and the gradient recurrence ``_bwd_call``.
The port's ``LSTM`` runs it for a unidirectional layer, and for each
direction of a bidirectional layer whose batch the merged kernels of
``ops.bilstm`` cannot hold (``bilstm.merged_bidir_fits``). The lean
forward takes any batch: its wide plan (H above ``NARROW_MAX_H``) tiles
the batch over the grid, its narrow plan gives each row a few lanes. The
residual-saving forward and the gradient split at the same width: a
narrow plan on a row's lanes (no batch limit) and a wide plan of one
persistent launch, which takes ``MAX_FWD_BATCH`` and ``MAX_BWD_BATCH``
rows; the kernel sources state all three constants.

Layout contract: ``xp`` [T, B, 4H] is the projected input
``x W_ih^T + b_ih + b_hh`` in real time order; ``w`` [4H, H] is torch's
``weight_hh_l{k}``; ``reverse`` runs the recurrence T-1 -> 0 over inputs
and outputs kept in real time order. Returns ``h`` [T, B, H] in real time
order.

Dispatch of :func:`lstm_sequence`, as ``bilstm.bilstm_sequence``'s: when
autograd is recording and an input requires grad, :class:`LSTMFunction`
runs the residual-saving forward and, in its backward, the gradient
recurrence, then ``dW_hh`` as one matmul outside the kernel (as
``_vjp_bwd`` does); otherwise the lean forward runs. On CUDA tensors each
launches its kernel (``csrc/lstm_infer.cu``, ``csrc/lstm_bwd.cu``) or
raises; on CPU tensors each runs its plain version, the per-direction
loops of ``ops.bilstm``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from speechsplit_tpu_torch.ops import _build
from speechsplit_tpu_torch.ops.bilstm import (
    A4C,
    MAX_HIDDEN,
    _barrier_word,
    _device,
    _recording,
    _stream,
    check_residual_dtype,
    refuse_bf16_compute,
    lstm_direction_backward_reference,
    lstm_direction_forward_reference,
    refuse_bf16_residuals,
)

# kernel launches since the last reset, per kernel; the main path's proof
# that it ran
LAUNCHES = {"lstm_infer": 0, "lstm_fwd": 0, "lstm_bwd": 0}

# the largest batch the training kernels take, as their sources state it
MAX_FWD_BATCH = _build.source_constant("lstm_infer", "kMaxBatch")
MAX_BWD_BATCH = _build.source_constant("lstm_bwd", "kMaxBatch")
# the lean forward's border: the narrow plan up to this width, then wide
NARROW_MAX_H = _build.source_constant("lstm_infer", "kNarrowMaxH")
# lstm_infer_launch's plan argument: by width, or one forced to measure it
_PLANS = {"auto": 0, "narrow": 1, "wide": 2}


def lstm_sequence_reference(xp, w, reverse: bool):
    """The plain PyTorch version of the lean kernel: ``h`` (any
    device; differentiable by autograd)."""
    return lstm_direction_forward_reference(xp, w, reverse)[0]


def _check(xp, w, what: str, max_batch: int | None) -> None:
    """Type, layout and shape of a kernel's inputs; ``max_batch`` None
    for a kernel without a batch limit."""
    if xp.dtype != torch.float32 or w.dtype != torch.float32:
        raise NotImplementedError(
            f"{what} runs float32 only; bfloat16 compute is {A4C}"
        )
    if not (xp.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what} needs contiguous tensors")
    if xp.dim() != 3 or xp.shape[-1] % 4:
        raise ValueError(f"xp must be [T, B, 4H], got {tuple(xp.shape)}")
    t_len, batch, four_h = xp.shape
    hidden = four_h // 4
    if tuple(w.shape) != (four_h, hidden):
        raise ValueError(
            f"w must be [4H, H] = [{four_h}, {hidden}], got {tuple(w.shape)}"
        )
    if not (t_len >= 1 and 1 <= hidden <= MAX_HIDDEN and batch >= 1
            and (max_batch is None or batch <= max_batch)):
        limit = "" if max_batch is None else (
            f" and B <= {max_batch} (the kernel's batch limit)")
        raise ValueError(
            f"{what} takes H <= {MAX_HIDDEN}{limit}, got T={t_len} "
            f"B={batch} H={hidden}"
        )


def _check_residuals(dh, g, c) -> None:
    """The gradient kernel's residual inputs beside ``g`` [T, B, 4H]."""
    shape = tuple(g.shape)
    hshape = shape[:2] + (shape[2] // 4,)
    for name, x in (("dh", dh), ("c", c)):
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"lstm_bwd takes float32 {name}; bfloat16 residuals are "
                f"{A4C}"
            )
        if not x.is_contiguous() or tuple(x.shape) != hshape:
            raise ValueError(
                f"{name} must be a contiguous {hshape}, got {tuple(x.shape)}"
            )


def _library():
    lib = _build.load("lstm_infer")
    lib.lstm_infer_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.lstm_infer_launch.restype = ctypes.c_int
    lib.lstm_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.lstm_fwd_launch.restype = ctypes.c_int
    lib.lstm_error_string.argtypes = [ctypes.c_int]
    lib.lstm_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library():
    lib = _build.load("lstm_bwd")
    lib.lstm_bwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.lstm_bwd_launch.restype = ctypes.c_int
    lib.lstm_bwd_error_string.argtypes = [ctypes.c_int]
    lib.lstm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def lstm_infer_cuda(xp, w, reverse: bool):
    """Launch the lean forward of ``csrc/lstm_infer.cu``: ``h``, by the
    narrow plan up to ``NARROW_MAX_H`` and the wide one above."""
    return _lstm_infer_plan(xp, w, reverse, "auto")


def _lstm_infer_plan(xp, w, reverse: bool, plan: str):
    """:func:`lstm_infer_cuda` in ``plan``: "auto", or "narrow" (H <=
    ``NARROW_MAX_H``) or "wide" forced, which only a measurement of the
    plans asks for."""
    _check(xp, w, "lstm_infer", None)
    t_len, batch, four_h = xp.shape
    h = xp.new_empty(t_len, batch, four_h // 4)
    c = xp.new_empty(batch, four_h // 4)  # the wide plan's cell state
    lib = _library()
    err = lib.lstm_infer_launch(
        xp.data_ptr(), w.data_ptr(), h.data_ptr(), c.data_ptr(), t_len,
        batch, four_h // 4, int(reverse), _PLANS[plan], xp.device.index or 0,
        _stream(xp),
    )
    _build.check(err, "lstm_infer", lib.lstm_error_string)
    LAUNCHES["lstm_infer"] += 1
    return h


def lstm_forward_cuda(xp, w, reverse: bool):
    """Launch the residual-saving forward of ``csrc/lstm_infer.cu``:
    ``(h, g, c)``, by the narrow plan up to ``NARROW_MAX_H`` and the wide
    one above."""
    _check(xp, w, "lstm_fwd", MAX_FWD_BATCH)
    t_len, batch, four_h = xp.shape
    h = xp.new_empty(t_len, batch, four_h // 4)
    c = torch.empty_like(h)
    g = torch.empty_like(xp)
    lib = _library()
    err = lib.lstm_fwd_launch(
        xp.data_ptr(), w.data_ptr(), h.data_ptr(), g.data_ptr(), c.data_ptr(),
        _barrier_word(xp).data_ptr(), t_len, batch, four_h // 4,
        int(reverse), xp.device.index or 0, _stream(xp),
    )
    _build.check(err, "lstm_fwd", lib.lstm_error_string)
    LAUNCHES["lstm_fwd"] += 1
    return h, g, c


def lstm_backward_cuda(dh, g, c, w, reverse: bool):
    """Launch ``csrc/lstm_bwd.cu``: ``dx`` [T, B, 4H], by the narrow plan
    up to H = 32 (``kLaneMaxH`` of ``csrc/lane_bwd.cuh``) and the wide
    one above."""
    _check(g, w, "lstm_bwd", MAX_BWD_BATCH)
    _check_residuals(dh, g, c)
    t_len, batch, four_h = g.shape
    dx = torch.empty_like(g)
    lib = _bwd_library()
    err = lib.lstm_bwd_launch(
        dh.data_ptr(), g.data_ptr(), c.data_ptr(), w.data_ptr(),
        dx.data_ptr(), _barrier_word(g).data_ptr(), t_len, batch,
        four_h // 4, int(reverse), g.device.index or 0, _stream(g),
    )
    _build.check(err, "lstm_bwd", lib.lstm_bwd_error_string)
    LAUNCHES["lstm_bwd"] += 1
    return dx


def dw_hh(h, dx, reverse: bool):
    """dW_hh [4H, H] as one matmul: the sum over t, b of dx[t] h_prev[t]^T
    with the processing predecessor h[t-1] (forward) or h[t+1] (reverse),
    over contiguous slices (``_vjp_bwd``, pallas_lstm.py:554-560)."""
    h_prev, d = (h[1:], dx[:-1]) if reverse else (h[:-1], dx[1:])
    return d.flatten(0, 1).t() @ h_prev.flatten(0, 1)


class LSTMFunction(torch.autograd.Function):
    """``lstm_sequence`` under autograd: the residual-saving forward, and
    the gradient recurrence plus ``dW_hh`` in the backward. CUDA tensors
    launch the kernels; CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, xp, w, reverse):
        if xp.is_cuda:
            # the backward's kernel must hold the batch too
            _check(xp, w, "lstm_sequence under autograd", MAX_BWD_BATCH)
            h, g, c = lstm_forward_cuda(xp, w, reverse)
        else:
            h, g, c = lstm_direction_forward_reference(xp, w, reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(h, g, c, w)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        h, g, c, w = ctx.saved_tensors
        dh = dh.contiguous()
        if g.is_cuda:
            dx = lstm_backward_cuda(dh, g, c, w, ctx.reverse)
        else:
            dx = lstm_direction_backward_reference(dh, g, c, w, ctx.reverse)
        return dx, dw_hh(h, dx, ctx.reverse), None


def lstm_sequence(xp, w, reverse: bool = False,
                  residual_dtype=torch.float32):
    """One LSTM direction over ``xp``; see the module docstring. It runs
    float32 only (a bfloat16 ``xp`` or ``w``, bfloat16 compute, raises on
    either device), and under autograd it saves float32 residuals only:
    ``residual_dtype`` bfloat16 raises (ROADMAP.md A4c)."""
    _device("lstm_sequence", (xp, w))
    check_residual_dtype(residual_dtype, "lstm_sequence")
    refuse_bf16_compute((xp, w), "lstm_sequence (the single-direction route)")
    if _recording((xp, w)):
        refuse_bf16_residuals(
            residual_dtype,
            "lstm_sequence under autograd (the single-direction route)")
        return LSTMFunction.apply(xp, w, reverse)
    if xp.is_cuda:
        return lstm_infer_cuda(xp, w, reverse)
    return lstm_sequence_reference(xp, w, reverse)
