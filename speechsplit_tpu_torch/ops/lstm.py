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
loops of ``ops.bilstm``, which take every dtype below.

Precision, as the JAX op's (``lstm_sequence(..., residual_dtype)``,
pallas_lstm.py:487-567): under autograd the residuals g and c are saved
in ``residual_dtype``, float32 or bfloat16 (None: ``bilstm.
RESIDUAL_DTYPE``, bfloat16, the JAX default). ``ops.bilstm``'s four
stream switches set the rest, as they set the merged op's: dh enters the
gradient in ``_dh_stream_dtype`` and dxp leaves it in
``_grad_stream_dtype`` (its d_pre carry float32 either way), h leaves the
forwards in ``_h_stream_dtype``; dW_hh rounds h and dxp to the residual
dtype and sums in float32 (``_dw_contract``), then takes W's dtype; dxp
goes back to autograd in xp's dtype. xp and W_hh are each float32 or
bfloat16, in any pair (``bilstm.check_compute``): a bfloat16 W_hh makes
a step's product read h_{t-1} (the gradient's d_pre) rounded to
bfloat16, a bfloat16 xp is widened where it is read; the sums, gates, c
and the h carry stay float32. The kernels take the sets the models form;
the op brings every other one to them by casts that change no value,
as the merged op does (``bilstm.kernel_set``, ``bilstm.
kernel_streams``).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from speechsplit_tpu_torch.ops import _build
from speechsplit_tpu_torch.ops.bilstm import (
    MAX_HIDDEN,
    _barrier_word,
    _bf16,
    _device,
    _h_stream_dtype,
    _recording,
    _resolve_residual,
    _stream,
    _streams,
    check_compute,
    check_residual_dtype,
    contract_dw,
    kernel_set,
    kernel_streams,
    lstm_direction_backward_reference,
    lstm_direction_forward_reference,
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
# the element types the kernels take (which sets: _check)
_DTYPES = (torch.float32, torch.bfloat16)


def lstm_sequence_reference(xp, w, reverse: bool):
    """The plain PyTorch version of the lean kernel: ``h`` (any
    device; differentiable by autograd)."""
    return lstm_direction_forward_reference(xp, w, reverse)[0]


def _check(xp, w, what: str, max_batch: int | None,
           residual_dtype=None) -> None:
    """Type, layout and shape of a forward kernel's inputs; ``max_batch``
    None for a kernel without a batch limit. The dtype sets the kernels
    take (``bilstm.kernel_set``): W_hh float32 beside a float32 xp; W_hh
    bfloat16 beside a float32 or a bfloat16 xp, and for the
    residual-saving forward (``residual_dtype`` given) xp in the
    residuals' dtype. Any other set raises ValueError."""
    if xp.dtype not in _DTYPES or w.dtype not in _DTYPES or kernel_set(
            xp.dtype, w.dtype, residual_dtype) != (xp.dtype, residual_dtype):
        raise ValueError(
            f"{what} takes xp {xp.dtype} beside W_hh {w.dtype} (residuals "
            f"{residual_dtype}) nowhere: xp is float32, or bfloat16 beside "
            f"a bfloat16 W_hh and its residuals (bilstm.kernel_set)"
        )
    _check_shapes(xp, w, what, max_batch)


def _check_shapes(xp, w, what: str, max_batch: int | None) -> None:
    """Layout and shape of [T, B, 4H] ``xp`` (or g) beside ``w`` [4H, H]."""
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
    """The gradient kernel's residual inputs beside ``g`` [T, B, 4H]: dh,
    g and c in one residual dtype, float32 or bfloat16 (the op brings a
    dh of another dtype to it, ``bilstm.kernel_streams``)."""
    shape = tuple(g.shape)
    hshape = shape[:2] + (shape[2] // 4,)
    check_residual_dtype(g.dtype, "lstm_bwd")
    for name, x in (("dh", dh), ("c", c)):
        if x.dtype != g.dtype:
            raise ValueError(
                f"lstm_bwd takes dh, g and c in one residual dtype: {name} "
                f"is {x.dtype}, g {g.dtype}"
            )
        if not x.is_contiguous() or tuple(x.shape) != hshape:
            raise ValueError(
                f"{name} must be a contiguous {hshape}, got {tuple(x.shape)}"
            )


def _library():
    lib = _build.load("lstm_infer")
    lib.lstm_infer_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.lstm_infer_launch.restype = ctypes.c_int
    lib.lstm_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.lstm_fwd_launch.restype = ctypes.c_int
    lib.lstm_error_string.argtypes = [ctypes.c_int]
    lib.lstm_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library():
    lib = _build.load("lstm_bwd")
    lib.lstm_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
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
    plans asks for. h is float32 at every dtype set."""
    _check(xp, w, "lstm_infer", None)
    t_len, batch, four_h = xp.shape
    h = xp.new_empty(t_len, batch, four_h // 4, dtype=torch.float32)
    c = torch.empty_like(h[0])  # the wide plan's cell state
    lib = _library()
    err = lib.lstm_infer_launch(
        xp.data_ptr(), w.data_ptr(), h.data_ptr(), c.data_ptr(), t_len,
        batch, four_h // 4, int(reverse), _PLANS[plan], _bf16(w), _bf16(xp),
        xp.device.index or 0, _stream(xp),
    )
    _build.check(err, "lstm_infer", lib.lstm_error_string)
    LAUNCHES["lstm_infer"] += 1
    return h


def lstm_forward_cuda(xp, w, reverse: bool, residual_dtype=torch.float32):
    """Launch the residual-saving forward of ``csrc/lstm_infer.cu``:
    ``(h, g, c)``, g and c in ``residual_dtype`` (the kernel rounds them as
    it stores them; h stays float32), by the narrow plan up to
    ``NARROW_MAX_H`` and the wide one above."""
    check_residual_dtype(residual_dtype, "lstm_fwd")
    _check(xp, w, "lstm_fwd", MAX_FWD_BATCH, residual_dtype)
    t_len, batch, four_h = xp.shape
    h = xp.new_empty(t_len, batch, four_h // 4, dtype=torch.float32)
    c = torch.empty_like(h, dtype=residual_dtype)
    g = torch.empty_like(xp, dtype=residual_dtype)
    lib = _library()
    err = lib.lstm_fwd_launch(
        xp.data_ptr(), w.data_ptr(), h.data_ptr(), g.data_ptr(), c.data_ptr(),
        _barrier_word(xp).data_ptr(), t_len, batch, four_h // 4,
        int(reverse), int(residual_dtype == torch.bfloat16), _bf16(w),
        _bf16(xp), xp.device.index or 0, _stream(xp),
    )
    _build.check(err, "lstm_fwd", lib.lstm_error_string)
    LAUNCHES["lstm_fwd"] += 1
    return h, g, c


def lstm_backward_cuda(dh, g, c, w, reverse: bool):
    """Launch ``csrc/lstm_bwd.cu``: ``dx`` [T, B, 4H] in the residuals'
    dtype, by the narrow plan up to H = 32 (``kLaneMaxH`` of
    ``csrc/lane_bwd.cuh``) and the wide one above. With bfloat16
    residuals the wide plan carries d_pre from step to step in a float32
    scratch of two steps and stores dx rounded beside it, so the carry
    stays unrounded (pallas_lstm.py:432-440); the narrow plan carries it in
    registers. W_hh float32, or bfloat16 (bfloat16 compute: the product
    reads d_pre rounded to bfloat16)."""
    if w.dtype not in _DTYPES:
        raise ValueError(f"lstm_bwd takes W_hh float32 or bfloat16, got "
                         f"{w.dtype}")
    _check_shapes(g, w, "lstm_bwd", MAX_BWD_BATCH)
    _check_residuals(dh, g, c)
    t_len, batch, four_h = g.shape
    dx = torch.empty_like(g)
    bf16 = g.dtype == torch.bfloat16
    # [step parity][B][4H], the wide plan's float32 d_pre
    carry = (torch.empty(2, batch, four_h, device=g.device)
             if bf16 and four_h // 4 > NARROW_MAX_H else None)
    lib = _bwd_library()
    err = lib.lstm_bwd_launch(
        dh.data_ptr(), g.data_ptr(), c.data_ptr(), w.data_ptr(),
        dx.data_ptr(), _barrier_word(g).data_ptr(),
        None if carry is None else carry.data_ptr(), t_len, batch,
        four_h // 4, int(reverse), int(bf16), _bf16(w), g.device.index or 0,
        _stream(g),
    )
    _build.check(err, "lstm_bwd", lib.lstm_bwd_error_string)
    LAUNCHES["lstm_bwd"] += 1
    return dx


def dw_hh(h, dx, reverse: bool, residual_dtype=torch.float32,
          w_dtype=torch.float32):
    """dW_hh [4H, H] as one matmul: the sum over t, b of dx[t] h_prev[t]^T
    with the processing predecessor h[t-1] (forward) or h[t+1] (reverse),
    over contiguous slices (``_vjp_bwd``, pallas_lstm.py:554-560), the
    operands rounded to ``residual_dtype`` (``bilstm.contract_dw``) and the
    sum rounded to W_hh's ``w_dtype`` (``_dw_contract``)."""
    h_prev, d = (h[1:], dx[:-1]) if reverse else (h[:-1], dx[1:])
    return contract_dw(h_prev, d, residual_dtype).to(w_dtype)


class LSTMFunction(torch.autograd.Function):
    """``lstm_sequence`` under autograd (``_vjp_fwd``, ``_vjp_bwd``,
    pallas_lstm.py:511-564): the residual-saving forward (residuals in
    ``residual_dtype``, h in the h stream's dtype), and the gradient
    recurrence plus ``dW_hh`` in the backward, dh entering in the dh
    stream's dtype, dxp handed back in xp's dtype (pallas_lstm.py:564:
    bfloat16 where the xp stream is) and dW_hh in W's. Each runs on the
    instance ``bilstm.kernel_set`` (``kernel_streams``) picks: CUDA
    tensors launch the kernels; CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, xp, w, reverse, residual_dtype):
        ctx.streams = _streams(w.dtype, residual_dtype)
        xd, rd = kernel_set(xp.dtype, w.dtype, residual_dtype)
        xk = xp.to(xd)
        if xp.is_cuda:
            # the backward's kernel must hold the batch too
            _check(xk, w, "lstm_sequence under autograd", MAX_BWD_BATCH, rd)
            h, g, c = lstm_forward_cuda(xk, w, reverse, rd)
        else:
            h, g, c = lstm_direction_forward_reference(xk, w, reverse, rd)
        h, g, c = (h.to(ctx.streams["h"]), g.to(residual_dtype),
                   c.to(residual_dtype))
        ctx.reverse = reverse
        ctx.xp_dtype = xp.dtype
        ctx.save_for_backward(h, g, c, w)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        h, g, c, w = ctx.saved_tensors
        dd, xd = ctx.streams["dh"], ctx.streams["dx"]
        kd = kernel_streams(g.dtype, dd, xd)
        # the cotangent enters in the dh stream's dtype, as _vjp_bwd rounds
        # it (pallas_lstm.py:547-551)
        dh = dh.to(dd).to(kd).contiguous()
        run = lstm_backward_cuda if g.is_cuda else (
            lstm_direction_backward_reference)
        dx = run(dh, g.to(kd), c.to(kd), w, ctx.reverse).to(xd)
        return (dx.to(ctx.xp_dtype),
                dw_hh(h, dx, ctx.reverse, g.dtype, w.dtype), None, None)


def lstm_sequence(xp, w, reverse: bool = False, residual_dtype=None):
    """One LSTM direction over ``xp``; see the module docstring. Under
    autograd the residuals are saved in ``residual_dtype``
    (``lstm_sequence``'s argument of the same name in JAX; None:
    ``bilstm.RESIDUAL_DTYPE``). h comes back in ``_h_stream_dtype``. The
    dtypes are checked here, on either device
    (:func:`bilstm.check_compute`)."""
    _device("lstm_sequence", (xp, w))
    residual_dtype = _resolve_residual(residual_dtype)
    check_residual_dtype(residual_dtype, "lstm_sequence")
    check_compute(xp.dtype, w.dtype, "lstm_sequence")
    if _recording((xp, w)):
        return LSTMFunction.apply(xp, w, reverse, residual_dtype)
    xk = xp.to(kernel_set(xp.dtype, w.dtype)[0])
    run = lstm_infer_cuda if xp.is_cuda else lstm_sequence_reference
    return run(xk, w, reverse).to(_h_stream_dtype(w.dtype, residual_dtype))
