"""N independent narrow BiLSTMs in one kernel launch.

Counterpart of ``speechsplit_tpu/ops/pallas_multilstm.py::
multi_bilstm_sequence`` and its custom VJP: the lean forward ``_infer``,
the residual-saving forward ``_fwd`` and the gradient recurrence
``_bwd_call``. The generator's encoder recurrences (content layer 0
H=8, pitch H=32, rhythm H=1) and the F0 converter's (f0 H=32, rhythm
H=1) are independent of each other and latency-bound, so they run
together.

Arguments as in the JAX op, its residual dtype a keyword:
``multi_bilstm_sequence(n, xp_f0, xp_b0, ..., xp_f{n-1}, xp_b{n-1},
w_f0, w_b0, ..., w_f{n-1}, w_b{n-1}, residual_dtype=None)`` (None:
``bilstm.RESIDUAL_DTYPE``, bfloat16, the JAX default)
with ``xp_*`` [T, B, 4H_s] in real time order and ``w_*`` [4H_s, H_s]
in torch's ``weight_hh_l{k}`` layout. Returns the 2n outputs
``(h_f0, h_b0, ...)``, each [T, B, H_s] in real time order.

Precision, as the JAX op's VJP (pallas_multilstm.py:312-433): under
autograd the gates g and the cell states c are saved in the residual
dtype, float32 or bfloat16; the cotangents dh enter the gradient kernel
in float32 and its dx leaves in float32 (unlike the merged op's streams,
which follow the residual dtype); ``dW_hh`` rounds h and dx to the
residual dtype (``_dw_contract``). Both plans run both residual dtypes:
the lane plans (every width up to ``LANE_MAX_H``) and the block plans (a
call with a wider direction, up to ``MAX_HIDDEN``).

bfloat16 compute, as the JAX model's ``streams`` mode feeds the op: each
``w_*`` float32 or bfloat16 on its own (the encoders' W_hh of H >= 2 in
bfloat16 beside the H=1 rhythm stream's float32 one, in one call), xp, h
and dx float32. A direction with a bfloat16 W multiplies h_{t-1} and, in
the gradient, d_pre rounded to bfloat16, and its dW_hh is rounded to
bfloat16 (``_dw_contract``). Both plans run it. h is float32 at every
dtype, as JAX's multi-stream op writes it (no stream switch enters).

A bfloat16 xp (JAX's op takes one, though its models feed float32) is
widened to float32 before the launch, which changes no value: the
kernels take float32 xp and widen nothing else. JAX hands back a
float32 cotangent for a bfloat16 xp (pallas_multilstm.py:415-435);
torch's autograd casts a Function's gradient to its input's dtype, so
the port's comes back rounded to bfloat16.

Which calls the kernels take at all: :func:`fits` (at most
``MAX_DIRECTIONS`` directions, each at most ``MAX_HIDDEN`` wide). The
generators gate their multi-stream call on it and run each encoder's
own layer elsewhere, as JAX's ``_fuse_encoder_group`` gates its.

Dispatch as in ``ops.bilstm``: under autograd (an input requires grad)
:class:`MultiBiLSTMFunction` runs the residual-saving forward and, in
its backward, the gradient recurrence plus one ``dW_hh`` matmul per
direction (``_vjp_bwd``); otherwise the lean forward. CUDA tensors
launch ``csrc/multi_bilstm_infer.cu`` / ``csrc/multi_bilstm_bwd.cu`` or
raise; CPU tensors run the plain versions.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from speechsplit_tpu_torch.ops import _build
from speechsplit_tpu_torch.ops.bilstm import (
    DTYPES,
    _resolve_residual,
    check_residual_dtype,
    contract_dw,
    lstm_direction_backward_reference,
    lstm_direction_forward_reference,
)

# kernel launches since the last reset, per kernel; the main path's proof
# that it ran
LAUNCHES = {"multi_bilstm_infer": 0, "multi_bilstm_fwd": 0,
            "multi_bilstm_bwd": 0}

# the kernels' limits, as the lean and residual-saving kernels' source
# states them (csrc/multi_bilstm_bwd.cu states the same)
MAX_DIRECTIONS = _build.source_constant("multi_bilstm_infer", "kMaxDirs")
MAX_HIDDEN = _build.source_constant("multi_bilstm_infer", "kMaxH")
# the lane plans' widest direction; a call with a wider one runs the block
# plans
LANE_MAX_H = _build.source_constant("multi_bilstm_infer", "kLaneMaxH")


def fits(widths) -> bool:
    """Can one multi-stream launch run BiLSTMs of these widths (one a
    stream)? True where their 2n directions are at most ``MAX_DIRECTIONS``
    and every width is at most ``MAX_HIDDEN``, both as the kernels'
    source states them. It depends on the widths alone, never on the
    device or the dtypes, so the CPU and the card take the same route.
    JAX's ``pallas_multilstm.fits`` is a VMEM budget with no width limit
    (pallas_multilstm.py:101-107): widths past ``MAX_HIDDEN`` run the
    multi-stream kernel there and each encoder's own layer here."""
    widths = tuple(widths)
    return (1 <= 2 * len(widths) <= MAX_DIRECTIONS
            and all(1 <= h <= MAX_HIDDEN for h in widths))


def _split(n: int, args):
    if len(args) != 4 * n:
        raise ValueError(f"expected {4 * n} arrays for n={n}, got {len(args)}")
    return args[: 2 * n], args[2 * n :]


def multi_bilstm_forward_reference(n: int, *args, residual_dtype=None):
    """The plain version of the residual-saving kernel: the 2n h, then
    the 2n post-activation gates g, then the 2n c (``_fwd``'s order), g
    and c in ``residual_dtype`` (None: xp's dtype)."""
    xps, ws = _split(n, args)
    outs = [lstm_direction_forward_reference(xp, w, bool(d % 2),
                                             residual_dtype)
            for d, (xp, w) in enumerate(zip(xps, ws))]
    return tuple(o[k] for k in range(3) for o in outs)


def multi_bilstm_sequence_reference(n: int, *args):
    """The plain PyTorch version of the lean kernel (any device)."""
    return multi_bilstm_forward_reference(n, *args)[: 2 * n]


def multi_bilstm_backward_reference(n: int, *args):
    """The plain version of the gradient kernel: args are the 2n dh, g,
    c and w; returns the 2n dx in dh's dtype, float32 (``_bwd_call``
    without its c-edge duplicates), whatever the residuals' dtype."""
    if len(args) != 8 * n:
        raise ValueError(f"expected {8 * n} arrays for n={n}, got {len(args)}")
    d2 = 2 * n
    dhs, gs, cs, ws = (args[k * d2 : (k + 1) * d2] for k in range(4))
    return tuple(
        lstm_direction_backward_reference(dh, g, c, w, bool(d % 2),
                                          dx_dtype=dh.dtype)
        for d, (dh, g, c, w) in enumerate(zip(dhs, gs, cs, ws))
    )


def compute_plan(xps, ws) -> None:
    """The dtypes the op takes: each xp and each W_hh float32 or
    bfloat16 on its own (bfloat16 compute), on either plan; the kernels
    read xp in float32 (:func:`_check`; the op widens a bfloat16 one).
    Any other dtype raises ValueError."""
    for name, group in (("xp", xps), ("w", ws)):
        for x in group:
            if x.dtype not in DTYPES:
                raise ValueError(f"multi_bilstm_sequence: {name} must be "
                                 f"float32 or bfloat16, got {x.dtype}")


def _widened(xps):
    """The xp streams as the kernels read them, in float32 (exact)."""
    return tuple(xp.float() for xp in xps)


def _check(n: int, xps, ws, xp_float32: bool = True) -> None:
    """Types, layout and shapes of the 2n [T, B, 4H] tensors and W_hh;
    ``xp_float32`` False for the gradient's g, in the residual dtype."""
    if not 1 <= 2 * n <= MAX_DIRECTIONS:
        raise ValueError(f"multi_bilstm_infer takes 1..4 streams, got {n}")
    compute_plan(xps if xp_float32 else (), ws)
    shape = xps[0].shape
    for xp, w in zip(xps, ws):
        if xp_float32 and xp.dtype != torch.float32:
            raise ValueError(
                f"multi_bilstm_sequence takes float32 xp, got {xp.dtype}")
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


def _check_residuals(dhs, gs, cs) -> None:
    """The gradient kernel's inputs: g and c of every direction in one
    residual dtype, float32 or bfloat16; dh float32 (JAX's multi-stream
    VJP does not round the cotangents)."""
    check_residual_dtype(gs[0].dtype, "multi_bilstm_bwd")
    for dh, g, c in zip(dhs, gs, cs):
        hshape = tuple(g.shape[:2]) + (g.shape[2] // 4,)
        for name, x, want, dtype in (
                ("dh", dh, hshape, torch.float32),
                ("c", c, hshape, gs[0].dtype),
                ("g", g, tuple(g.shape), gs[0].dtype)):
            if x.dtype != dtype:
                raise ValueError(
                    f"multi_bilstm_bwd takes float32 dh and g, c in one "
                    f"residual dtype: {name} is {x.dtype}, g {gs[0].dtype}"
                )
            if not x.is_contiguous() or tuple(x.shape) != want:
                raise ValueError(
                    f"{name} must be a contiguous {want}, got "
                    f"{tuple(x.shape)}"
                )


def _library():
    lib = _build.load("multi_bilstm_infer")
    # hs, w_bf16, T, B, device, stream
    tail = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.multi_bilstm_infer_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + tail)
    lib.multi_bilstm_infer_launch.restype = ctypes.c_int
    # n_dirs, xp, w, h, g, c, resid_bf16, hs, ...
    lib.multi_bilstm_fwd_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] + tail)
    lib.multi_bilstm_fwd_launch.restype = ctypes.c_int
    lib.multi_bilstm_error_string.argtypes = [ctypes.c_int]
    lib.multi_bilstm_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library():
    lib = _build.load("multi_bilstm_bwd")
    # n_dirs, dh, g, c, w, dx, resid_bf16, hs, w_bf16, T, B, device, stream
    lib.multi_bilstm_bwd_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.multi_bilstm_bwd_launch.restype = ctypes.c_int
    lib.multi_bilstm_bwd_error_string.argtypes = [ctypes.c_int]
    lib.multi_bilstm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))


def _widths(xps):
    return (ctypes.c_int * len(xps))(*(x.shape[-1] // 4 for x in xps))


def _w_bf16(ws):
    """The kernels' per-direction flags: 1 where W_hh is bfloat16."""
    return (ctypes.c_int * len(ws))(*(int(w.dtype == torch.bfloat16)
                                      for w in ws))


def _new_h(xps):
    t_len, batch, _ = xps[0].shape
    return tuple(xp.new_empty(t_len, batch, xp.shape[-1] // 4) for xp in xps)


def multi_bilstm_infer_cuda(n: int, *args):
    """Launch the lean forward of ``csrc/multi_bilstm_infer.cu``."""
    xps, ws = _split(n, args)
    _check(n, xps, ws)
    t_len, batch, _ = xps[0].shape
    device = xps[0].device
    outs = _new_h(xps)
    lib = _library()
    err = lib.multi_bilstm_infer_launch(
        2 * n, _ptrs(xps), _ptrs(ws), _ptrs(outs), _widths(xps), _w_bf16(ws),
        t_len, batch, device.index or 0,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "multi_bilstm_infer", lib.multi_bilstm_error_string)
    LAUNCHES["multi_bilstm_infer"] += 1
    return outs


def multi_bilstm_forward_cuda(n: int, *args, residual_dtype=torch.float32):
    """Launch the residual-saving forward of ``csrc/multi_bilstm_infer.cu``:
    the 2n h, 2n g and 2n c, as :func:`multi_bilstm_forward_reference`,
    g and c in ``residual_dtype`` (rounded by the kernel as it stores
    them)."""
    xps, ws = _split(n, args)
    _check(n, xps, ws)
    check_residual_dtype(residual_dtype, "multi_bilstm_fwd")
    t_len, batch, _ = xps[0].shape
    device = xps[0].device
    hs = _new_h(xps)
    cs = tuple(h.new_empty(h.shape, dtype=residual_dtype) for h in hs)
    gs = tuple(torch.empty_like(xp, dtype=residual_dtype) for xp in xps)
    lib = _library()
    err = lib.multi_bilstm_fwd_launch(
        2 * n, _ptrs(xps), _ptrs(ws), _ptrs(hs), _ptrs(gs), _ptrs(cs),
        int(residual_dtype == torch.bfloat16), _widths(xps), _w_bf16(ws),
        t_len, batch, device.index or 0,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "multi_bilstm_fwd", lib.multi_bilstm_error_string)
    LAUNCHES["multi_bilstm_fwd"] += 1
    return hs + gs + cs


def multi_bilstm_backward_cuda(n: int, *args):
    """Launch ``csrc/multi_bilstm_bwd.cu``; arguments and result as
    :func:`multi_bilstm_backward_reference` (g and c float32 or bfloat16,
    dh and dx float32)."""
    if len(args) != 8 * n:
        raise ValueError(f"expected {8 * n} arrays for n={n}, got {len(args)}")
    d2 = 2 * n
    dhs, gs, cs, ws = (args[k * d2 : (k + 1) * d2] for k in range(4))
    _check(n, gs, ws, xp_float32=False)
    _check_residuals(dhs, gs, cs)
    t_len, batch, _ = gs[0].shape
    device = gs[0].device
    dxs = tuple(torch.empty_like(g, dtype=torch.float32) for g in gs)
    lib = _bwd_library()
    err = lib.multi_bilstm_bwd_launch(
        d2, _ptrs(dhs), _ptrs(gs), _ptrs(cs), _ptrs(ws), _ptrs(dxs),
        int(gs[0].dtype == torch.bfloat16), _widths(gs), _w_bf16(ws), t_len,
        batch, device.index or 0,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "multi_bilstm_bwd", lib.multi_bilstm_bwd_error_string)
    LAUNCHES["multi_bilstm_bwd"] += 1
    return dxs


def _dw(h, dx, reverse: bool, residual_dtype=torch.float32,
        w_dtype=torch.float32):
    """One direction's dW_hh [4H, H] over contiguous slices: the
    predecessor is h[t-1] forward and h[t+1] backward (``_vjp_bwd``,
    pallas_multilstm.py:420-434), the operands rounded to
    ``residual_dtype``, the sum to W_hh's ``w_dtype``
    (``_dw_contract``)."""
    h_sl, dx_sl = (h[1:], dx[:-1]) if reverse else (h[:-1], dx[1:])
    return contract_dw(h_sl, dx_sl, residual_dtype).to(w_dtype)


class MultiBiLSTMFunction(torch.autograd.Function):
    """``multi_bilstm_sequence`` under autograd; see the module docstring.
    The xp cotangents leave float32, and autograd rounds those of
    bfloat16 xp to bfloat16."""

    @staticmethod
    def forward(ctx, n, residual_dtype, *args):
        run = multi_bilstm_forward_cuda if args[0].is_cuda else (
            multi_bilstm_forward_reference)
        d2 = 2 * n
        outs = run(n, *_widened(args[:d2]), *args[d2:],
                   residual_dtype=residual_dtype)
        hs = outs[:d2]
        ctx.n = n
        ctx.save_for_backward(*outs, *args[d2:])
        return hs

    @staticmethod
    @once_differentiable
    def backward(ctx, *dhs):
        n = ctx.n
        d2 = 2 * n
        saved = ctx.saved_tensors
        hs, gs, cs, ws = (saved[k * d2 : (k + 1) * d2] for k in range(4))
        # views of torch.cat halves made contiguous (autograd gives an
        # unused output's cotangent as zeros)
        dhs = tuple(dh.contiguous() for dh in dhs)
        run = multi_bilstm_backward_cuda if gs[0].is_cuda else (
            multi_bilstm_backward_reference)
        dxs = run(n, *dhs, *gs, *cs, *ws)
        dws = tuple(_dw(h, dx, bool(d % 2), gs[0].dtype, w.dtype)
                    for d, (h, dx, w) in enumerate(zip(hs, dxs, ws)))
        return (None, None, *dxs, *dws)


def multi_bilstm_sequence(n: int, *args, residual_dtype=None):
    """n independent BiLSTMs; see the module docstring. Under autograd
    the residuals are saved in ``residual_dtype`` (None:
    ``bilstm.RESIDUAL_DTYPE``)."""
    devices = {x.device.type for x in args}
    if devices not in ({"cuda"}, {"cpu"}):
        raise ValueError(f"multi_bilstm_sequence: tensors on {sorted(devices)}")
    residual_dtype = _resolve_residual(residual_dtype)
    check_residual_dtype(residual_dtype, "multi_bilstm_sequence")
    compute_plan(*_split(n, args))
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return MultiBiLSTMFunction.apply(n, residual_dtype, *args)
    run = multi_bilstm_infer_cuda if devices == {"cuda"} else (
        multi_bilstm_sequence_reference)
    return run(n, *_widened(args[: 2 * n]), *args[2 * n:])
