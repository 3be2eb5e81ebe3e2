"""One bidirectional LSTM layer, both directions in one kernel launch.

Counterpart of ``speechsplit_tpu/ops/pallas_lstm.py::bilstm_sequence``
and its custom VJP: the lean forward ``_bd_infer``, the residual-saving
forward ``_bd_fwd`` and the gradient recurrence ``_bd_bwd_call``; and of
``bilstm_sequence_fused``, which spans the input projection too (inside
the kernel: ``_bdp_infer`` and ``_bdp_fwd``). Carries the mel decoder (3
layers, H=512), the F0 decoder (2 layers, H=256) and content-encoder
layer 1 (H=8).

Layout contract: ``xp_f``, ``xp_b`` [T, B, 4H] are the projected inputs
``x W_ih^T + b_ih + b_hh`` of the forward and backward direction, both
in real time order; ``w_f``, ``w_b`` are [4H, H], torch's
``weight_hh_l{k}`` layout (the transpose of the JAX package's [H, 4H]).
The fused op takes the layer input ``x`` [T, B, I] in real time order,
``wi_f``, ``wi_b`` [4H, I] (torch's ``weight_ih_l{k}``) and the summed
biases ``b_f``, ``b_b`` [4H] (``b_ih + b_hh``, formed by the caller so
that autograd splits their gradient). Every op returns ``(h_f, h_b)``,
each [T, B, H] in real time order.

Dispatch of :func:`bilstm_sequence` (and of the fused op): when
autograd is recording and an input requires grad, an
``autograd.Function`` runs the residual-saving forward and, in its
backward, the gradient recurrence, then ``dW_hh`` (and for the fused
op ``dW_ih``, ``db`` and ``dx``) as matmuls outside the kernel (as
``_bd_vjp_bwd`` and ``_bdp_vjp_bwd`` do); otherwise the lean forward
runs. On CUDA tensors each launches its kernel (``csrc/bilstm_infer.cu``,
``csrc/bilstm_bwd.cu``) or raises; on CPU tensors each runs its plain
PyTorch version, so the CPU tests exercise the same forward and backward
math the kernels implement, not autograd of a plain loop.

Precision, as the JAX op's (``bilstm_sequence(..., residual_dtype)``):
under autograd the residuals g and c are saved in ``residual_dtype``,
float32 or bfloat16; None is :data:`RESIDUAL_DTYPE`, bfloat16, the JAX
default (pallas_lstm.py:79-83). JAX's four stream switches
(pallas_lstm.py:86-210) are this module's, with their names and
defaults, read where a call is made:
- ``GRAD_STREAM_FOLLOWS_RESIDUAL``: the gradient kernel writes dxp in
  bfloat16 beside bfloat16 residuals (:func:`_grad_stream_dtype`), its
  d_pre carry float32 either way (pallas_lstm.py:826);
- ``DH_STREAM_FOLLOWS_RESIDUAL``: the cotangent dh enters it rounded to
  bfloat16 beside bfloat16 residuals (:func:`_dh_stream_dtype`);
- ``XP_STREAM_FOLLOWS_COMPUTE``: a layer feeds bfloat16 xp streams where
  W_hh and the residuals are both bfloat16 (:func:`stream_dtype`);
- ``H_STREAM_FOLLOWS_COMPUTE`` (off): the forwards write h in bfloat16
  where W_hh and the residuals are both bfloat16
  (:func:`_h_stream_dtype`); only the stored h is rounded, the carry
  stays float32, so the bfloat16 h is the float32 h rounded, bit for bit.
dW_hh rounds h and dxp to the residual dtype and sums in float32
(``_dw_contract``), then takes W's dtype; dxp goes back to autograd in
xp's dtype. The switches exist for parity with JAX's ops and its switch
tests; no model of the port sets them.

The ops take every float32/bfloat16 set JAX's ops take
(:func:`check_compute`): xp of either dtype beside W_hh of either, at
either residual dtype. A bfloat16 W_hh (the JAX ``compute_dtype=
"bfloat16"``) makes a step's product read h_{t-1} rounded to bfloat16
(``_cell``, pallas_lstm.py:591-594) and the gradient's read d_pre rounded
to bfloat16 (``_cell_bwd``, :825-828); a bfloat16 xp is widened where it
is read; the sums, gates, c and the h carry stay float32. The fused op
takes x, the pair W_ih and the pair W_hh each in float32 or bfloat16
(:func:`check_fused_compute`), the biases float32: its projection
multiplies x rounded to W_ih's dtype by W_ih and sums in float32, then
adds the bias (``_proj``, pallas_lstm.py:1207-1220); under autograd it
saves g and c in ``residual_dtype`` and its backward follows
``_bdp_vjp_bwd``.

The kernels take the sets the models form (:func:`kernel_set`); the ops
bring every other set or switch setting to one of them by casts that
change no value: a bfloat16 stream is widened to float32 before the
launch, and an output the op wants narrower than the kernel wrote (h, g
and c of a forward, dx of the gradient) is rounded after it, as a kernel
rounds where it stores, its carries float32. So every set runs the
kernels, and each result equals JAX's rounding bit for bit where JAX's
does. The fused kernels take W_ih and W_hh in one dtype; a mixed pair
(no model forms one) projects outside them and runs the merged kernels,
the route ``PROJ_FUSION = "off"`` takes.

:func:`bilstm_layer` (JAX's ``bilstm_layer``, routed by ``LAYER_VJP``,
"off" as in JAX) spans the projection and the recurrence in one
``autograd.Function``: the same forward as the composed path, and a
backward that forms dW_ih and dx from operands rounded to the residual
dtype (``_layer_vjp_bwd``, pallas_lstm.py:1071-1101).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from speechsplit_tpu_torch.ops import _build

# kernel launches since the last reset, per kernel; the main path's proof
# that it ran
LAUNCHES = {"bilstm_infer": 0, "bilstm_fwd": 0, "bilstm_bwd": 0,
            "bilstm_fused_infer": 0, "bilstm_fused_fwd": 0}

MAX_HIDDEN = 512
# the residual dtypes the training kernels store
RESIDUAL_DTYPES = (torch.float32, torch.bfloat16)
# the dtype residual_dtype=None stands for (pallas_lstm.py:79)
RESIDUAL_DTYPE = torch.bfloat16
# the element types the ops take for every stream and weight
DTYPES = (torch.float32, torch.bfloat16)

# JAX's stream switches (pallas_lstm.py:103, :118, :145, :163), with their
# defaults; see the module docstring
GRAD_STREAM_FOLLOWS_RESIDUAL = True
XP_STREAM_FOLLOWS_COMPUTE = True
DH_STREAM_FOLLOWS_RESIDUAL = True
H_STREAM_FOLLOWS_COMPUTE = False

# "on": a merged BiLSTM layer the fused plan does not take runs
# bilstm_layer; "off": the projection, then bilstm_sequence. Off by
# default, as in the JAX package (pallas_lstm.py:1018).
LAYER_VJP = "off"

# "auto": a merged BiLSTM layer projects its input inside the kernel
# wherever fused_proj_plan approves; "off": never. Off by default, as in
# the JAX package (pallas_lstm.py:1135-1139).
PROJ_FUSION = "off"
# the largest batch the fused kernels take, as their source states it
MAX_FUSED_BATCH = _build.source_constant("bilstm_infer", "kMaxFusedBatch")
# the unfused kernels' shared-memory plans, as their sources state them
_INFER_UNITS = _build.source_constant("bilstm_infer", "kMaxUnits")
_INFER_SMEM_FLOATS = _build.source_constant("bilstm_infer",
                                            "kUnfusedSmemFloats")
_INFER_SPLIT_MAX_H = _build.source_constant("bilstm_infer", "kSplitMaxH")
_BWD_UNITS = _build.source_constant("bilstm_bwd", "kMaxUnits")
_BWD_VALS = _build.source_constant("bilstm_bwd", "kVals")
_BWD_SMEM_FLOATS = _build.source_constant("bilstm_bwd", "kBwdSmemFloats")


def _resolve_residual(residual_dtype) -> torch.dtype:
    """``residual_dtype``, or :data:`RESIDUAL_DTYPE` for None
    (pallas_lstm._resolve_residual)."""
    return RESIDUAL_DTYPE if residual_dtype is None else residual_dtype


def _grad_stream_dtype(residual_dtype) -> torch.dtype:
    """The dtype of the dxp stream the gradient writes: bfloat16 beside
    bfloat16 residuals while ``GRAD_STREAM_FOLLOWS_RESIDUAL`` (pallas_lstm.
    py:193-197), else float32."""
    rd = _resolve_residual(residual_dtype)
    if GRAD_STREAM_FOLLOWS_RESIDUAL and rd == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def _dh_stream_dtype(compute_dtype, residual_dtype) -> torch.dtype:
    """The dtype the cotangent dh enters the gradient in:
    bfloat16 beside bfloat16 residuals while ``DH_STREAM_FOLLOWS_RESIDUAL``
    (pallas_lstm.py:166-177; the compute dtype does not enter), else
    float32."""
    del compute_dtype
    rd = _resolve_residual(residual_dtype)
    if DH_STREAM_FOLLOWS_RESIDUAL and rd == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def _h_stream_dtype(compute_dtype, residual_dtype) -> torch.dtype:
    """The dtype of the h stream the forwards write: bfloat16 where W_hh's
    ``compute_dtype`` and the residuals are both bfloat16 while
    ``H_STREAM_FOLLOWS_COMPUTE`` (pallas_lstm.py:180-190), else float32."""
    rd = _resolve_residual(residual_dtype)
    if (H_STREAM_FOLLOWS_COMPUTE and compute_dtype == torch.bfloat16
            and rd == torch.bfloat16):
        return torch.bfloat16
    return torch.float32


def _work_dtype(dtype) -> torch.dtype:
    """The dtype the plain loops compute in beside a stream or weight of
    ``dtype``: bfloat16 is widened to float32, other dtypes kept."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def operand(x, dtype):
    """The operand of a product at compute ``dtype`` (W_hh's dtype in the
    recurrences): x rounded to bfloat16 (JAX's ``x.astype(dtype)``: the
    layers' products, pallas_lstm._cell's h and _cell_bwd's d_pre) and
    widened again, so that the product is a float32 one of rounded values
    (never a bfloat16 GEMM that rounds its result); x itself at any other
    dtype."""
    if dtype != torch.bfloat16:
        return x
    return x.to(torch.bfloat16).to(x.dtype)


def lstm_direction_forward_reference(xp, w, reverse: bool,
                                     residual_dtype=None):
    """Plain time loop of one direction (pallas_lstm._cell): xp
    [T, B, 4H] and w [4H, H], both in real time order. Returns h
    [T, B, H] and the residuals: the post-activation gates i, f, g, o
    [T, B, 4H] and c [T, B, H], stored in ``residual_dtype`` (bfloat16:
    rounded to nearest even as ``_bd_fwd``'s block writes round them;
    None: the working dtype); h and the c carry stay in the working
    dtype, xp's (float32 for a bfloat16 xp). A bfloat16 w (bfloat16
    compute) multiplies h_{t-1} rounded to bfloat16."""
    t_len, batch, four_h = xp.shape
    work = _work_dtype(xp.dtype)
    w_t = w.to(work).t()
    h = xp.new_zeros(batch, four_h // 4, dtype=work)
    c = torch.zeros_like(h)
    hs, gs, cs = [None] * t_len, [None] * t_len, [None] * t_len
    for t in range(t_len - 1, -1, -1) if reverse else range(t_len):
        i, f, g, o = (xp[t].to(work) + operand(h, w.dtype) @ w_t).chunk(
            4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[t] = h
        gs[t] = torch.cat([i, f, g, o], dim=-1).to(residual_dtype or work)
        cs[t] = c.to(residual_dtype or work)
    return torch.stack(hs), torch.stack(gs), torch.stack(cs)


def lstm_direction_backward_reference(dh, g, c, w, reverse: bool,
                                      dx_dtype=None):
    """Plain time loop of pallas_lstm._cell_bwd for one direction.

    dh [T, B, H] is the cotangent of h; g, c the forward's residuals.
    The gradient walks the recurrence backwards (T-1 -> 0 for a forward
    direction, 0 -> T-1 for a backward one) with the dh and dc carries
    from zero; c_prev is the cell state of the recurrence's previous
    step, zero at its first. dh, g and c may be bfloat16: each is widened
    to the working dtype (w's; float32 for a bfloat16 w) where it is read,
    as ``_cell_bwd`` widens them, and the carries, d_pre among them, stay
    in it: beside a float32 w the next step's product reads d_pre
    unrounded, beside a bfloat16 one (bfloat16 compute) rounded to
    bfloat16. Returns dx = d_pre [T, B, 4H], stored in ``dx_dtype``
    (default g's: the merged kernel's gradient stream follows the
    residual dtype, pallas_lstm.py:103).
    """
    t_len, batch, hidden = dh.shape
    work = _work_dtype(w.dtype)
    w_work = w.to(work)
    dh_st = dh.new_zeros(batch, hidden, dtype=work)
    dc_st = torch.zeros_like(dh_st)
    zero = torch.zeros_like(dh_st)
    dx = [None] * t_len
    for t in range(t_len) if reverse else range(t_len - 1, -1, -1):
        tc = t + 1 if reverse else t - 1
        c_prev = c[tc].to(work) if 0 <= tc < t_len else zero
        i, f, gg, o = g[t].to(work).chunk(4, dim=-1)
        tanh_c = torch.tanh(c[t].to(work))
        d = dh[t].to(work) + dh_st
        d_o = d * tanh_c
        dc = dc_st + d * o * (1.0 - tanh_c * tanh_c)
        d_pre = torch.cat([
            dc * gg * i * (1.0 - i),
            dc * c_prev * f * (1.0 - f),
            dc * i * (1.0 - gg * gg),
            d_o * o * (1.0 - o),
        ], dim=-1)
        dx[t] = d_pre.to(g.dtype if dx_dtype is None else dx_dtype)
        dh_st = operand(d_pre, w.dtype) @ w_work
        dc_st = dc * f
    return torch.stack(dx)


def bilstm_forward_reference(xp_f, xp_b, w_f, w_b, residual_dtype=None):
    """The plain version of the residual-saving kernel:
    ``(h_f, h_b, g_f, g_b, c_f, c_b)``, as ``_bd_fwd`` returns them, g and
    c in ``residual_dtype`` (None: the working dtype)."""
    h_f, g_f, c_f = lstm_direction_forward_reference(xp_f, w_f, False,
                                                     residual_dtype)
    h_b, g_b, c_b = lstm_direction_forward_reference(xp_b, w_b, True,
                                                     residual_dtype)
    return h_f, h_b, g_f, g_b, c_f, c_b


def bilstm_sequence_reference(xp_f, xp_b, w_f, w_b):
    """The plain PyTorch version of the lean kernel (any device)."""
    return bilstm_forward_reference(xp_f, xp_b, w_f, w_b)[:2]


def bilstm_backward_reference(dh_f, dh_b, g_f, g_b, c_f, c_b, w_f, w_b):
    """The plain version of the gradient kernel: ``(dx_f, dx_b)``, as
    ``_bd_bwd_call`` returns them, in the residuals' dtype."""
    return (
        lstm_direction_backward_reference(dh_f, g_f, c_f, w_f, False),
        lstm_direction_backward_reference(dh_b, g_b, c_b, w_b, True),
    )


def project(x, wi, b):
    """The fused kernels' projection ``x W_ih^T + b`` [.., 4H], float32:
    one ``F.linear`` at float32; otherwise x rounded to W_ih's dtype
    (``_proj``'s ``x.astype(wi.dtype)``), the products of the widened
    values summed in float32, then the float32 bias (JAX's ``_proj``). A
    product of two bfloat16 values is exact in float32 (and in TF32)."""
    x = fused_input(x, wi.dtype)
    if x.dtype == torch.float32 and wi.dtype == torch.float32:
        return F.linear(x, wi, b)
    return F.linear(x.float(), wi.float()) + b


def project_promoted(x, wi, b):
    """``x W_ih^T + b`` as JAX's ``_project_xla`` forms it (the layer
    VJP's projection, pallas_lstm.py:1021-1025): x and W_ih of one dtype
    as :func:`project` multiplies them; of two, both widened to float32
    (``jnp.dot``'s promotion), x never rounded."""
    if x.dtype != wi.dtype:
        x, wi = x.float(), wi.float()
    return project(x, wi, b)


def fused_input(x, wi_dtype):
    """x as the fused kernels stream it, in W_ih's dtype: rounded to
    bfloat16 (nearest even, as ``_proj``'s ``x.astype(wi.dtype)``) or
    widened to float32 (exact)."""
    return x.to(wi_dtype)


def bilstm_fused_forward_reference(x, wi_f, wi_b, b_f, b_b, w_f, w_b,
                                   residual_dtype=None):
    """The plain version of the fused residual-saving kernel: a per-row
    projection (:func:`project`), then the direction loops; ``(h_f, h_b,
    g_f, g_b, c_f, c_b)``, as ``_bdp_fwd`` returns them, g and c in
    ``residual_dtype`` (None: float32)."""
    return bilstm_forward_reference(project(x, wi_f, b_f),
                                    project(x, wi_b, b_b), w_f, w_b,
                                    residual_dtype)


def bilstm_sequence_fused_reference(x, wi_f, wi_b, b_f, b_b, w_f, w_b):
    """The plain version of the lean fused kernel: ``(h_f, h_b)``."""
    return bilstm_fused_forward_reference(x, wi_f, wi_b, b_f, b_b, w_f,
                                          w_b)[:2]


def _infer_units(h: int) -> int:
    """Hidden units a block of the unfused kernels runs at width ``h`` in
    the source's plan: two warps a unit above ``kMaxUnits`` up to
    ``kSplitMaxH``, else one."""
    splits = 2 if _INFER_UNITS < h <= _INFER_SPLIT_MAX_H else 1
    return min(h, _INFER_UNITS // splits)


def merged_max_batch(h: int, grad: bool = False) -> int:
    """The largest batch the merged kernels a layer of width ``h`` runs
    can take: ``bilstm_infer`` (4984 rows at H=512, 10,104 at H=256,
    5110 at H=8), and under autograd also ``bilstm_fwd`` (4982, 10,102,
    5108) and ``bilstm_bwd`` (4842 at H=512, 4970 at H=256, 5094 at H=8),
    so 4842, 4970 and 5094. Each kernel holds its cell state (the
    gradient's dc carry), [units][B], and one batch row of its staging in
    the shared memory its source states. The forwards run units = min(H,
    8) a block, 4 from H=9 to ``kSplitMaxH`` (256), and stage two buffers
    of h_{t-1} (H padded to 4) and 4 gate inputs a unit, ``bilstm_fwd``
    also h and c a unit; the gradient runs min(H, 8) units and stages the
    previous d_pre (4H) and ``kVals`` floats a unit (the 8 warps' partial
    sums and two buffers of 7 residuals)."""
    if not grad:
        return forward_max_batch(h, resid=False)
    units = min(h, _BWD_UNITS)
    return min(forward_max_batch(h, resid=True),
               (_BWD_SMEM_FLOATS - 4 * h - _BWD_VALS * units) // units)


def forward_max_batch(h: int, resid: bool) -> int:
    """The largest batch ``bilstm_infer`` (``bilstm_fwd`` with ``resid``)
    takes at width ``h`` in the source's plan: the cell state [units][B]
    beside one row of two buffers of h_{t-1} and the gate inputs, and with
    ``resid`` h and c a unit (``launch_unfused`` in the source)."""
    units = _infer_units(h)
    row = 2 * (-(-h // 4) * 4 + 4 * units) + (2 * units if resid else 0)
    return (_INFER_SMEM_FLOATS - row) // units


def merged_bidir_fits(t: int, b: int, h: int, grad: bool = False) -> bool:
    """Can the merged kernels run a BiLSTM layer of this shape? True
    exactly where every merged kernel the layer runs takes the batch
    (:func:`merged_max_batch`; ``grad``: the layer runs under autograd);
    any T. Where it is false, ``models.layers.LSTM`` runs each direction
    through ``ops.lstm.lstm_sequence``, whose kernels take larger batches.

    JAX's function of the same name (pallas_lstm.py:679-690) is a TPU
    budget: Mosaic's VMEM for the resident W_hh of both directions and
    the double-buffered blocks of a fold of steps, which refuses B above
    about 950 at H=512. It is not carried over: the CUDA kernels hold up
    to 4984 rows at H=512 in one launch (4842 under autograd), and JAX's
    threshold would move the mel decoder of a conversion of about 137 to
    712 pairs (7 rows a pair) off that launch onto two serial
    single-direction ones (PERF.md §6 times both routes). So the two
    plans differ between about 950 and 4984 rows at H=512. The numerics do not
    depend on the route: both compute the same sums, and agree to float32
    rounding."""
    return t >= 1 and 1 <= h <= MAX_HIDDEN and (
        1 <= b <= merged_max_batch(h, grad))


def fused_proj_plan(t: int, b: int, h: int, i: int, dtype) -> bool:
    """Should a merged BiLSTM layer of this shape project its input
    inside the kernel (``bilstm_sequence_fused``)? False under
    ``PROJ_FUSION = "off"``; under ``"auto"`` true wherever the CUDA
    kernel holds the shape: H <= MAX_HIDDEN and B <= MAX_FUSED_BATCH, any
    T and I, at W_hh's ``dtype`` float32 or bfloat16 (the kernels' shared
    memory holds float32 K-tiles at either, so the limits are one).

    The JAX plan (pallas_lstm.py:1192-1204) is a TPU budget: VMEM for the
    resident W_ih and W_hh and a fold that fills the MXU's 128-row tile,
    with B a multiple of the 8-row sublane tile. It is not carried over,
    so the two plans differ: B=28 fuses here but not in JAX, nor does a
    layer whose weights pass JAX's VMEM ceiling (I above about 2000 at
    H=512). The numerics do not depend on the route: fused and composed
    compute the same sums.

    "auto" is a parity switch: it stays off by default, and a plan that
    turns it on waits for the conversion measurements (PERF.md, ROADMAP
    B)."""
    if PROJ_FUSION not in ("off", "auto"):
        raise ValueError(f"PROJ_FUSION must be 'off' or 'auto', got "
                         f"{PROJ_FUSION!r}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_proj_plan: W_hh must be float32 or "
                         f"bfloat16, got {dtype}")
    return (PROJ_FUSION == "auto" and t >= 1
            and i >= 1 and 1 <= h <= MAX_HIDDEN
            and 1 <= b <= MAX_FUSED_BATCH)


def stream_dtype(w_dtype, residual_dtype) -> torch.dtype:
    """The dtype of the xp streams a layer feeds the merged kernels:
    bfloat16 where W_hh and the residuals (None: :data:`RESIDUAL_DTYPE`)
    are both bfloat16 while ``XP_STREAM_FOLLOWS_COMPUTE``, else float32
    (``pallas_lstm.stream_dtype``, pallas_lstm.py:200-209)."""
    rd = _resolve_residual(residual_dtype)
    if (XP_STREAM_FOLLOWS_COMPUTE and w_dtype == torch.bfloat16
            and rd == torch.bfloat16):
        return torch.bfloat16
    return torch.float32


def check_residual_dtype(dtype, what: str) -> None:
    """Refuse a residual dtype the training kernels do not store."""
    if dtype not in RESIDUAL_DTYPES:
        raise ValueError(f"{what}: residual_dtype must be float32 or "
                         f"bfloat16, got {dtype}")


def check_compute(xp_dtype, w_dtype, what: str = "bilstm_sequence") -> None:
    """The dtypes the recurrences run (the merged forwards, and ``what``
    ``lstm_sequence`` the single-direction ones): xp and W_hh each
    float32 or bfloat16, in any pair, as JAX's ops take them; another
    dtype raises ValueError."""
    for name, dtype in (("xp", xp_dtype), ("w", w_dtype)):
        if dtype not in DTYPES:
            raise ValueError(f"{what}: {name} must be float32 or "
                             f"bfloat16, got {dtype}")


def kernel_set(xp_dtype, w_dtype, residual_dtype=None):
    """``(xp dtype, residual dtype)`` of the forward kernel instance that
    runs a set (``residual_dtype`` None: the lean forward). The kernels
    take the sets the models form: xp float32 beside a float32 W_hh, and
    beside a bfloat16 one xp of either dtype, in the residuals' dtype
    where they are saved; such a set runs as it is. Another runs with xp
    widened to float32 and, beside a bfloat16 W_hh, float32 residuals
    that the op rounds after the launch. Neither cast changes a value
    the kernel computes: a kernel widens each stream where it reads it,
    and computes g and c in float32, rounding them only where it stores
    them."""
    if w_dtype == torch.float32:
        return torch.float32, residual_dtype
    if residual_dtype is None or xp_dtype == residual_dtype:
        return xp_dtype, residual_dtype
    return torch.float32, torch.float32


def check_kernel_set(xp_dtype, w_dtype, residual_dtype=None,
                     what: str = "bilstm_sequence") -> None:
    """Refuse, with ValueError, a set no forward kernel instance takes
    (:func:`kernel_set`; the ops bring every set to one that does)."""
    check_compute(xp_dtype, w_dtype, what)
    if kernel_set(xp_dtype, w_dtype, residual_dtype) != (
            xp_dtype, residual_dtype):
        raise ValueError(
            f"{what} takes xp {xp_dtype} beside W_hh {w_dtype} (residuals "
            f"{residual_dtype}) nowhere: xp is float32, or beside a "
            f"bfloat16 W_hh in the residuals' dtype (kernel_set)")


def _check(xp_f, xp_b, w_f, w_b) -> None:
    """Layout and shapes of a merged kernel's [T, B, 4H] pair and W_hh
    pair, each pair of one dtype (the dtypes themselves:
    :func:`check_compute`)."""
    tensors = (xp_f, xp_b, w_f, w_b)
    if xp_f.dtype != xp_b.dtype or w_f.dtype != w_b.dtype:
        raise ValueError(
            f"bilstm_sequence takes each pair in one dtype, got "
            f"{xp_f.dtype}/{xp_b.dtype} and {w_f.dtype}/{w_b.dtype}"
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


def _check_residuals(dh_f, dh_b, g_f, g_b, c_f, c_b, w_f) -> None:
    """The gradient kernel's inputs beside the forward's checks: dh, g
    and c all in one residual dtype, float32 or bfloat16 (the op brings a
    dh of another dtype to it, :func:`_recurrence_backward`)."""
    shape = tuple(g_f.shape)
    hshape = shape[:2] + (shape[2] // 4,)
    check_residual_dtype(g_f.dtype, "bilstm_bwd")
    for name, x, want in (("dh_f", dh_f, hshape), ("dh_b", dh_b, hshape),
                          ("g_f", g_f, shape), ("g_b", g_b, shape),
                          ("c_f", c_f, hshape), ("c_b", c_b, hshape)):
        if x.dtype != g_f.dtype:
            raise ValueError(
                f"bilstm_bwd takes dh, g and c in one residual dtype: "
                f"{name} is {x.dtype}, g_f {g_f.dtype}"
            )
        if not x.is_contiguous() or tuple(x.shape) != want:
            raise ValueError(
                f"{name} must be a contiguous {want}, got {tuple(x.shape)}"
            )
    if tuple(w_f.shape) != (shape[2], shape[2] // 4):
        raise ValueError(f"w must be [4H, H] beside g {shape}")


def check_fused_compute(x, wi_f, wi_b, b_f, b_b, w_f, w_b) -> None:
    """The dtypes the fused op runs: x, the W_ih pair and the W_hh pair
    each float32 or bfloat16 on its own (each pair in one dtype), the
    biases float32. The kernels stream x in W_ih's dtype
    (:func:`fused_input`); anything else raises ValueError."""
    ops = (x, wi_f, wi_b, w_f, w_b)
    for t in ops:
        if t.dtype not in DTYPES:
            raise ValueError(f"bilstm_sequence_fused takes float32 or "
                             f"bfloat16 x and weights, got {t.dtype}")
    if b_f.dtype != torch.float32 or b_b.dtype != torch.float32:
        raise ValueError("bilstm_sequence_fused takes float32 biases")
    if wi_f.dtype != wi_b.dtype or w_f.dtype != w_b.dtype:
        raise ValueError(
            f"bilstm_sequence_fused takes each weight pair in one dtype, "
            f"got W_ih {wi_f.dtype}/{wi_b.dtype}, W_hh "
            f"{w_f.dtype}/{w_b.dtype}")


def _check_fused(x, wi_f, wi_b, b_f, b_b, w_f, w_b) -> None:
    """The fused kernels' inputs: x [T, B, I], wi [4H, I], b [4H],
    w [4H, H], contiguous, in the dtypes :func:`check_fused_compute`
    takes, x, W_ih and W_hh in one dtype (the op brings x to W_ih's,
    :func:`fused_input`, and runs a mixed weight pair on the merged
    kernels)."""
    tensors = (x, wi_f, wi_b, b_f, b_b, w_f, w_b)
    check_fused_compute(*tensors)
    if len({x.dtype, wi_f.dtype, w_f.dtype}) > 1:
        raise ValueError(f"the fused kernels take x, W_ih and W_hh in one "
                         f"dtype, got {x.dtype}, {wi_f.dtype}, {w_f.dtype}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("bilstm_sequence_fused needs contiguous tensors")
    if x.dim() != 3:
        raise ValueError(f"x must be [T, B, I], got {tuple(x.shape)}")
    t_len, batch, i_dim = x.shape
    four_h = w_f.shape[0]
    hidden = four_h // 4
    for name, got, want in (
            ("wi_f", wi_f, (four_h, i_dim)), ("wi_b", wi_b, (four_h, i_dim)),
            ("b_f", b_f, (four_h,)), ("b_b", b_b, (four_h,)),
            ("w_f", w_f, (four_h, hidden)), ("w_b", w_b, (four_h, hidden))):
        if four_h % 4 or tuple(got.shape) != want:
            raise ValueError(f"{name} must be {want} beside x "
                             f"{tuple(x.shape)}, got {tuple(got.shape)}")
    if not (1 <= hidden <= MAX_HIDDEN and 1 <= batch <= MAX_FUSED_BATCH
            and t_len >= 1 and i_dim >= 1):
        raise ValueError(
            f"bilstm_sequence_fused takes H <= {MAX_HIDDEN} and B <= "
            f"{MAX_FUSED_BATCH}, got T={t_len} B={batch} I={i_dim} "
            f"H={hidden}"
        )


def _library():
    lib = _build.load("bilstm_infer")
    lib.bilstm_infer_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.bilstm_infer_launch.restype = ctypes.c_int
    lib.bilstm_fwd_launch.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.bilstm_fwd_launch.restype = ctypes.c_int
    # ..., T, B, H, I, compute_bf16, device, stream
    lib.bilstm_fused_infer_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.bilstm_fused_infer_launch.restype = ctypes.c_int
    # ..., T, B, H, I, resid_bf16, compute_bf16, device, stream
    lib.bilstm_fused_fwd_launch.argtypes = [ctypes.c_void_p] * 14 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.bilstm_fused_fwd_launch.restype = ctypes.c_int
    lib.bilstm_error_string.argtypes = [ctypes.c_int]
    lib.bilstm_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library():
    lib = _build.load("bilstm_bwd")
    lib.bilstm_bwd_launch.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.bilstm_bwd_launch.restype = ctypes.c_int
    lib.bilstm_bwd_error_string.argtypes = [ctypes.c_int]
    lib.bilstm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def _barrier_word(x: torch.Tensor, words: int = 1) -> torch.Tensor:
    """The zeroed counters of a kernel's split grid barrier
    (``csrc/merged_step.cuh``; the unfused forwards take one a
    direction), on x's device, zeroed on its stream before the launch
    that follows."""
    return torch.zeros(words, dtype=torch.int32, device=x.device)


def bilstm_infer_cuda(xp_f, xp_b, w_f, w_b):
    """Launch the lean forward of ``csrc/bilstm_infer.cu``."""
    return _bilstm_infer_plan(xp_f, xp_b, w_f, w_b, 0)


def _bilstm_infer_plan(xp_f, xp_b, w_f, w_b, splits: int):
    """:func:`bilstm_infer_cuda` with ``splits`` warps a hidden unit: 0
    for the source's plan, or 1 or 2 forced, which only a measurement of
    the plans asks for. h is float32 at every compute dtype."""
    _check(xp_f, xp_b, w_f, w_b)
    check_kernel_set(xp_f.dtype, w_f.dtype, what="bilstm_infer")
    t_len, batch, four_h = xp_f.shape
    h_f = xp_f.new_empty(t_len, batch, four_h // 4, dtype=torch.float32)
    h_b = torch.empty_like(h_f)
    lib = _library()
    err = lib.bilstm_infer_launch(
        xp_f.data_ptr(), xp_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
        h_f.data_ptr(), h_b.data_ptr(), _barrier_word(xp_f, 2).data_ptr(),
        t_len, batch, four_h // 4, splits, _bf16(w_f), _bf16(xp_f),
        xp_f.device.index or 0, _stream(xp_f),
    )
    _build.check(err, "bilstm_infer", lib.bilstm_error_string)
    LAUNCHES["bilstm_infer"] += 1
    return h_f, h_b


def bilstm_forward_cuda(xp_f, xp_b, w_f, w_b, residual_dtype=torch.float32):
    """Launch the residual-saving forward of ``csrc/bilstm_infer.cu``:
    ``(h_f, h_b, g_f, g_b, c_f, c_b)``, g and c in ``residual_dtype`` (the
    kernel rounds them as it stores them; h stays float32)."""
    _check(xp_f, xp_b, w_f, w_b)
    check_residual_dtype(residual_dtype, "bilstm_fwd")
    check_kernel_set(xp_f.dtype, w_f.dtype, residual_dtype, "bilstm_fwd")
    t_len, batch, four_h = xp_f.shape
    h_f = xp_f.new_empty(t_len, batch, four_h // 4, dtype=torch.float32)
    h_b = torch.empty_like(h_f)
    c_f, c_b = (torch.empty_like(h_f, dtype=residual_dtype) for _ in range(2))
    g_f, g_b = (torch.empty_like(xp_f, dtype=residual_dtype) for _ in range(2))
    lib = _library()
    err = lib.bilstm_fwd_launch(
        xp_f.data_ptr(), xp_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
        h_f.data_ptr(), h_b.data_ptr(), g_f.data_ptr(), g_b.data_ptr(),
        c_f.data_ptr(), c_b.data_ptr(), _barrier_word(xp_f, 2).data_ptr(),
        t_len, batch, four_h // 4, 0, int(residual_dtype == torch.bfloat16),
        _bf16(w_f), _bf16(xp_f), xp_f.device.index or 0, _stream(xp_f),
    )
    _build.check(err, "bilstm_fwd", lib.bilstm_error_string)
    LAUNCHES["bilstm_fwd"] += 1
    return h_f, h_b, g_f, g_b, c_f, c_b


def bilstm_backward_cuda(dh_f, dh_b, g_f, g_b, c_f, c_b, w_f, w_b):
    """Launch ``csrc/bilstm_bwd.cu``: ``(dx_f, dx_b)`` in the residuals'
    dtype. With bfloat16 residuals the kernel carries d_pre from step to
    step in a float32 scratch of two steps a direction and stores dx
    rounded beside it, so the carry stays unrounded (pallas_lstm.py:826).
    W_hh float32, or bfloat16 (bfloat16 compute: the product reads d_pre
    rounded to bfloat16)."""
    _check(g_f, g_b, w_f, w_b)
    check_compute(torch.float32, w_f.dtype)
    _check_residuals(dh_f, dh_b, g_f, g_b, c_f, c_b, w_f)
    t_len, batch, four_h = g_f.shape
    dx_f, dx_b = torch.empty_like(g_f), torch.empty_like(g_b)
    bf16 = g_f.dtype == torch.bfloat16
    # [direction][step parity][B][4H]
    carry = (torch.empty(2, 2, batch, four_h, device=g_f.device)
             if bf16 else None)
    barrier = _barrier_word(g_f)
    lib = _bwd_library()
    err = lib.bilstm_bwd_launch(
        dh_f.data_ptr(), dh_b.data_ptr(), g_f.data_ptr(), g_b.data_ptr(),
        c_f.data_ptr(), c_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
        dx_f.data_ptr(), dx_b.data_ptr(),
        carry.data_ptr() if bf16 else None, barrier.data_ptr(), t_len,
        batch, four_h // 4, int(bf16), _bf16(w_f), g_f.device.index or 0,
        _stream(g_f),
    )
    _build.check(err, "bilstm_bwd", lib.bilstm_bwd_error_string)
    LAUNCHES["bilstm_bwd"] += 1
    return dx_f, dx_b


def _fused_pointers(x, wi_f, wi_b, b_f, b_b, w_f, w_b):
    return [t.data_ptr() for t in (x, wi_f, wi_b, b_f, b_b, w_f, w_b)]


def bilstm_fused_infer_cuda(x, wi_f, wi_b, b_f, b_b, w_f, w_b):
    """Launch the lean forward of ``csrc/bilstm_infer.cu`` with the input
    projection in the kernel: ``(h_f, h_b)``, float32 at either compute
    dtype."""
    args = (x, wi_f, wi_b, b_f, b_b, w_f, w_b)
    _check_fused(*args)
    t_len, batch, i_dim = x.shape
    hidden = w_f.shape[1]
    h_f = x.new_empty(t_len, batch, hidden, dtype=torch.float32)
    h_b = torch.empty_like(h_f)
    lib = _library()
    err = lib.bilstm_fused_infer_launch(
        *_fused_pointers(*args), h_f.data_ptr(), h_b.data_ptr(),
        _barrier_word(x).data_ptr(), t_len, batch, hidden, i_dim, _bf16(w_f),
        x.device.index or 0, _stream(x),
    )
    _build.check(err, "bilstm_fused_infer", lib.bilstm_error_string)
    LAUNCHES["bilstm_fused_infer"] += 1
    return h_f, h_b


def bilstm_fused_forward_cuda(x, wi_f, wi_b, b_f, b_b, w_f, w_b,
                              residual_dtype=torch.float32):
    """Launch the residual-saving forward of ``csrc/bilstm_infer.cu`` with
    the input projection in the kernel: ``(h_f, h_b, g_f, g_b, c_f,
    c_b)``, g and c in ``residual_dtype`` (rounded by the kernel as it
    stores them), h float32."""
    args = (x, wi_f, wi_b, b_f, b_b, w_f, w_b)
    _check_fused(*args)
    check_residual_dtype(residual_dtype, "bilstm_fused_fwd")
    t_len, batch, i_dim = x.shape
    hidden = w_f.shape[1]
    h_f = x.new_empty(t_len, batch, hidden, dtype=torch.float32)
    h_b = torch.empty_like(h_f)
    c_f, c_b = (torch.empty_like(h_f, dtype=residual_dtype)
                for _ in range(2))
    g_f = x.new_empty(t_len, batch, 4 * hidden, dtype=residual_dtype)
    g_b = torch.empty_like(g_f)
    lib = _library()
    err = lib.bilstm_fused_fwd_launch(
        *_fused_pointers(*args), h_f.data_ptr(), h_b.data_ptr(),
        g_f.data_ptr(), g_b.data_ptr(), c_f.data_ptr(), c_b.data_ptr(),
        _barrier_word(x).data_ptr(), t_len, batch, hidden, i_dim,
        int(residual_dtype == torch.bfloat16), _bf16(w_f),
        x.device.index or 0, _stream(x),
    )
    _build.check(err, "bilstm_fused_fwd", lib.bilstm_error_string)
    LAUNCHES["bilstm_fused_fwd"] += 1
    return h_f, h_b, g_f, g_b, c_f, c_b


def contract_dw(h, dx, residual_dtype=torch.float32):
    """dW [4H, H] = sum over the (t, b) rows of dx^T h, as
    ``_dw_contract`` (pallas_lstm.py:523-542) forms it: both operands
    rounded to ``residual_dtype``, the products and sums float32, the
    result float32. The rounded operands are widened and multiplied in
    float32: a bfloat16 value fits TF32's mantissa, so the product is the
    same under TF32, and no bfloat16 GEMM rounds the result."""
    h = h.to(residual_dtype).float()
    dx = dx.to(residual_dtype).float()
    return dx.flatten(0, 1).t() @ h.flatten(0, 1)


def dw_hh(h_f, h_b, dx_f, dx_b, residual_dtype=torch.float32,
          w_dtype=torch.float32):
    """dW_hh of both directions as one matmul each, in torch's [4H, H]
    layout: sum over t, b of dx[t] h_prev[t]^T with the predecessor
    h[t-1] (forward) or h[t+1] (backward), over contiguous slices
    (``_bd_vjp_bwd``, pallas_lstm.py:981-982), the operands rounded to
    ``residual_dtype`` (:func:`contract_dw`), the sums rounded to W_hh's
    ``w_dtype`` (``_dw_contract``'s ``.astype(w.dtype)``)."""
    return (contract_dw(h_f[:-1], dx_f[1:], residual_dtype).to(w_dtype),
            contract_dw(h_b[1:], dx_b[:-1], residual_dtype).to(w_dtype))


def _streams(w_dtype, residual_dtype) -> dict:
    """The dtypes of one call's streams at the switches' settings now:
    h written by the forward, dh read and dx written by the gradient; a
    Function keeps them from its forward for its backward, as JAX fixes
    them when it traces the VJP."""
    return dict(h=_h_stream_dtype(w_dtype, residual_dtype),
                dh=_dh_stream_dtype(w_dtype, residual_dtype),
                dx=_grad_stream_dtype(residual_dtype))


def kernel_streams(residual_dtype, dh_dtype, dx_dtype) -> torch.dtype:
    """The residual dtype of the gradient kernel instance that runs a set:
    the residuals' own where dh and dx share it, as the kernels read and
    write them; else float32, the residuals widened for the launch and dx
    rounded after it (the kernels carry d_pre in float32 and round it only
    where they store dx)."""
    if dh_dtype == dx_dtype == residual_dtype:
        return residual_dtype
    return torch.float32


def _narrowed(outs, h_dtype, residual_dtype):
    """A forward's outputs in the op's dtypes: the h pair in ``h_dtype``,
    the residuals after them in ``residual_dtype`` (:func:`kernel_set`)."""
    return (tuple(x.to(h_dtype) for x in outs[:2])
            + tuple(x.to(residual_dtype) for x in outs[2:]))


def _forward(xp_f, xp_b, w_f, w_b, residual_dtype, h_dtype):
    """The merged forward of any set, on the instance :func:`kernel_set`
    picks (the kernel on CUDA, the plain version on the CPU): ``(h_f,
    h_b)`` for ``residual_dtype`` None (the lean forward), else also the
    residuals, in the op's dtypes."""
    xd, rd = kernel_set(xp_f.dtype, w_f.dtype, residual_dtype)
    xps = (xp_f.to(xd), xp_b.to(xd))
    if residual_dtype is None:
        run = bilstm_infer_cuda if xp_f.is_cuda else bilstm_sequence_reference
        outs = run(*xps, w_f, w_b)
    else:
        run = bilstm_forward_cuda if xp_f.is_cuda else (
            bilstm_forward_reference)
        outs = run(*xps, w_f, w_b, rd)
    return _narrowed(outs, h_dtype, residual_dtype)


def _recurrence_backward(ctx, dh_f, dh_b, h_f, h_b, g_f, g_b, c_f, c_b,
                         w_f, w_b):
    """The gradient recurrence (the kernel on CUDA, the plain loop on the
    CPU) on the instance :func:`kernel_streams` picks, then dW_hh:
    ``(dxp_f, dxp_b, dw_f, dw_b)``, dxp in the gradient stream's dtype, dW
    in W's. The cotangents dh enter rounded to the dh stream's dtype
    (pallas_lstm.py:969-974); both come from ``ctx.streams``."""
    rd = g_f.dtype
    dd, xd = ctx.streams["dh"], ctx.streams["dx"]
    kd = kernel_streams(rd, dd, xd)
    # the cotangents of torch.cat halves are views (autograd gives an
    # unused output's cotangent as zeros)
    dhs = [d.to(dd).to(kd).contiguous() for d in (dh_f, dh_b)]
    res = [x.to(kd) for x in (g_f, g_b, c_f, c_b)]
    run = bilstm_backward_cuda if g_f.is_cuda else bilstm_backward_reference
    dxp_f, dxp_b = (d.to(xd) for d in run(*dhs, *res, w_f, w_b))
    return (dxp_f, dxp_b) + dw_hh(h_f, h_b, dxp_f, dxp_b, rd, w_f.dtype)


def _fused_forward(x, wi_f, wi_b, b_f, b_b, w_f, w_b, residual_dtype,
                   h_dtype):
    """The fused forward of any set, as :func:`_forward`: x in W_ih's
    dtype (:func:`fused_input`); the fused kernel (its plain version on
    the CPU) where W_ih and W_hh share a dtype, else the projection
    outside it (:func:`project`) and the merged forward."""
    xk = fused_input(x, wi_f.dtype)
    if wi_f.dtype != w_f.dtype:
        return _forward(project(xk, wi_f, b_f), project(xk, wi_b, b_b),
                        w_f, w_b, residual_dtype, h_dtype)
    args = (xk, wi_f, wi_b, b_f, b_b, w_f, w_b)
    if residual_dtype is None:
        run = bilstm_fused_infer_cuda if x.is_cuda else (
            bilstm_sequence_fused_reference)
        outs = run(*args)
    else:
        run = bilstm_fused_forward_cuda if x.is_cuda else (
            bilstm_fused_forward_reference)
        outs = run(*args, residual_dtype)
    return _narrowed(outs, h_dtype, residual_dtype)


class BiLSTMFunction(torch.autograd.Function):
    """``bilstm_sequence`` under autograd (``_bd_vjp_fwd``,
    ``_bd_vjp_bwd``, pallas_lstm.py:954-988): the residual-saving forward
    (residuals in ``residual_dtype``, h in the h stream's dtype), and the
    gradient recurrence plus ``dW_hh`` in the backward, dxp handed back in
    xp's dtype (pallas_lstm.py:987: bfloat16 where the xp stream is) and
    dW_hh in W's. CUDA tensors launch the kernels; CPU tensors run the
    plain versions."""

    @staticmethod
    def forward(ctx, xp_f, xp_b, w_f, w_b, residual_dtype):
        ctx.streams = _streams(w_f.dtype, residual_dtype)
        outs = _forward(xp_f, xp_b, w_f, w_b, residual_dtype,
                        ctx.streams["h"])
        ctx.xp_dtype = xp_f.dtype
        ctx.save_for_backward(*outs, w_f, w_b)
        return outs[:2]

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_f, dh_b):
        dxp_f, dxp_b, dw_f, dw_b = _recurrence_backward(
            ctx, dh_f, dh_b, *ctx.saved_tensors)
        return (dxp_f.to(ctx.xp_dtype), dxp_b.to(ctx.xp_dtype), dw_f, dw_b,
                None)


def _dx_in(dxp, wi, dtype):
    """The projection's input gradient of one direction: dxp [T, B, 4H]
    and W_ih [4H, I] each rounded to ``dtype``, their products summed in
    float32 (JAX's ``dxin``: ``dtype`` is W_ih's in the fused VJP, the
    residuals' in the layer VJP; products of bfloat16 values are exact in
    float32)."""
    return dxp.to(dtype).float() @ wi.to(dtype).float()


def _projection_backward(dxp_f, dxp_b, x, wi_f, wi_b, rd, dx_dtype):
    """The projection's gradients as matmuls outside the kernels, as JAX
    leaves them to XLA: dW_ih = dxp^T x with both operands rounded to the
    residuals' dtype ``rd`` and the sum to W_ih's (``_dw_contract``), db =
    the float32 sum of dxp over (t, b), dx = dxp_f W_ih_f + dxp_b W_ih_b
    (:func:`_dx_in` at ``dx_dtype``) in x's dtype."""
    dwi_f = contract_dw(x, dxp_f, rd).to(wi_f.dtype)
    dwi_b = contract_dw(x, dxp_b, rd).to(wi_b.dtype)
    dx = (_dx_in(dxp_f, wi_f, dx_dtype or wi_f.dtype)
          + _dx_in(dxp_b, wi_b, dx_dtype or wi_b.dtype)).to(x.dtype)
    return (dx, dwi_f, dwi_b, dxp_f.float().sum((0, 1)),
            dxp_b.float().sum((0, 1)))


class BiLSTMFusedFunction(torch.autograd.Function):
    """``bilstm_sequence_fused`` under autograd. The forward is the fused
    residual-saving kernel (the projection inside it, x in W_ih's dtype;
    :func:`_fused_forward`) on CUDA, the plain version on the CPU, g and c
    in ``residual_dtype``; it saves the residuals and x as given, as
    ``_bdp_vjp_fwd`` does. The
    backward (``_bdp_vjp_bwd``, pallas_lstm.py:1414-1448) is the gradient
    recurrence and dW_hh (:func:`_recurrence_backward`), then the
    projection's gradients (:func:`_projection_backward`, dx's product at
    W_ih's dtype)."""

    @staticmethod
    def forward(ctx, x, wi_f, wi_b, b_f, b_b, w_f, w_b, residual_dtype):
        ctx.streams = _streams(w_f.dtype, residual_dtype)
        outs = _fused_forward(x, wi_f, wi_b, b_f, b_b, w_f, w_b,
                              residual_dtype, ctx.streams["h"])
        ctx.save_for_backward(*outs, x, wi_f, wi_b, w_f, w_b)
        return outs[:2]

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_f, dh_b):
        h_f, h_b, g_f, g_b, c_f, c_b, x, wi_f, wi_b, w_f, w_b = (
            ctx.saved_tensors)
        dxp_f, dxp_b, dw_f, dw_b = _recurrence_backward(
            ctx, dh_f, dh_b, h_f, h_b, g_f, g_b, c_f, c_b, w_f, w_b)
        dx, dwi_f, dwi_b, db_f, db_b = _projection_backward(
            dxp_f, dxp_b, x, wi_f, wi_b, g_f.dtype, None)
        return dx, dwi_f, dwi_b, db_f, db_b, dw_f, dw_b, None


class BiLSTMLayerFunction(torch.autograd.Function):
    """:func:`bilstm_layer` under autograd (``_layer_vjp_fwd``,
    ``_layer_vjp_bwd``, pallas_lstm.py:1055-1101). The forward projects x
    with float32 sums (:func:`project_promoted`), casts each stream to
    :func:`stream_dtype` (by W_ih's dtype) and runs the residual-saving
    merged forward; it saves the residuals and x. The backward runs the
    gradient recurrence and dW_hh (:func:`_recurrence_backward`), then
    dW_ih with operands rounded to the residual dtype, db the float32 sum,
    and dx the product of dxp and W_ih both rounded to the residual dtype,
    summed in float32 (:func:`_projection_backward`)."""

    @staticmethod
    def forward(ctx, x, wi_f, wi_b, b_f, b_b, w_f, w_b, residual_dtype):
        ctx.streams = _streams(w_f.dtype, residual_dtype)
        sd = stream_dtype(wi_f.dtype, residual_dtype)
        xp_f = project_promoted(x, wi_f, b_f).to(sd).contiguous()
        xp_b = project_promoted(x, wi_b, b_b).to(sd).contiguous()
        outs = _forward(xp_f, xp_b, w_f, w_b, residual_dtype,
                        ctx.streams["h"])
        ctx.save_for_backward(*outs, x, wi_f, wi_b, w_f, w_b)
        return outs[:2]

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_f, dh_b):
        h_f, h_b, g_f, g_b, c_f, c_b, x, wi_f, wi_b, w_f, w_b = (
            ctx.saved_tensors)
        dxp_f, dxp_b, dw_f, dw_b = _recurrence_backward(
            ctx, dh_f, dh_b, h_f, h_b, g_f, g_b, c_f, c_b, w_f, w_b)
        rd = g_f.dtype
        dx, dwi_f, dwi_b, db_f, db_b = _projection_backward(
            dxp_f, dxp_b, x, wi_f, wi_b, rd, rd)
        return dx, dwi_f, dwi_b, db_f, db_b, dw_f, dw_b, None


def _device(name: str, args) -> str:
    devices = {x.device.type for x in args}
    if devices not in ({"cuda"}, {"cpu"}):
        raise ValueError(f"{name}: tensors on {sorted(devices)}")
    return devices.pop()


def _recording(args) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in args)


def bilstm_sequence(xp_f, xp_b, w_f, w_b, residual_dtype=None):
    """Both BiLSTM directions of one layer; see the module docstring.
    Under autograd the residuals are saved in ``residual_dtype``
    (``bilstm_sequence``'s argument of the same name in JAX; None:
    :data:`RESIDUAL_DTYPE`). h comes back in :func:`_h_stream_dtype`. The
    dtypes are checked here, on either device (:func:`check_compute`)."""
    args = (xp_f, xp_b, w_f, w_b)
    _device("bilstm_sequence", args)
    residual_dtype = _resolve_residual(residual_dtype)
    check_residual_dtype(residual_dtype, "bilstm_sequence")
    check_compute(xp_f.dtype, w_f.dtype)
    if _recording(args):
        return BiLSTMFunction.apply(*args, residual_dtype)
    return _forward(*args, None, _h_stream_dtype(w_f.dtype, residual_dtype))


def _check_layer_args(name, args, residual_dtype):
    _device(name, args)
    check_residual_dtype(residual_dtype, name)
    check_fused_compute(*args)


def bilstm_sequence_fused(x, wi_f, wi_b, b_f, b_b, w_f, w_b,
                          residual_dtype=None):
    """One BiLSTM layer with its input projection inside the kernel
    (``pallas_lstm.bilstm_sequence_fused``); callers gate on
    :func:`fused_proj_plan`. See the module docstring for layouts and
    dtypes (:func:`check_fused_compute`, checked here on either device).
    Under autograd the residuals are saved in ``residual_dtype`` (None:
    :data:`RESIDUAL_DTYPE`)."""
    args = (x, wi_f, wi_b, b_f, b_b, w_f, w_b)
    residual_dtype = _resolve_residual(residual_dtype)
    _check_layer_args("bilstm_sequence_fused", args, residual_dtype)
    if _recording(args):
        return BiLSTMFusedFunction.apply(*args, residual_dtype)
    return _fused_forward(*args, None,
                          _h_stream_dtype(w_f.dtype, residual_dtype))


def bilstm_layer(x, wi_f, wi_b, b_f, b_b, w_f, w_b, residual_dtype=None):
    """One BiLSTM layer, the projection and the merged recurrence in one
    op (``pallas_lstm.bilstm_layer``; ``models.layers.LSTM`` routes a
    layer here under ``LAYER_VJP = "on"``): x [T, B, I], wi [4H, I], b
    [4H] (float32, b_ih + b_hh), w [4H, H], the fused op's dtypes. Its
    forward is the composed path's (:func:`project_promoted`, then
    :func:`bilstm_sequence`); under autograd :class:`BiLSTMLayerFunction`
    forms the projection's gradients at the residual dtype."""
    args = (x, wi_f, wi_b, b_f, b_b, w_f, w_b)
    residual_dtype = _resolve_residual(residual_dtype)
    _check_layer_args("bilstm_layer", args, residual_dtype)
    if _recording(args):
        return BiLSTMLayerFunction.apply(*args, residual_dtype)
    sd = stream_dtype(wi_f.dtype, residual_dtype)
    return bilstm_sequence(
        project_promoted(x, wi_f, b_f).to(sd).contiguous(),
        project_promoted(x, wi_b, b_b).to(sd).contiguous(), w_f, w_b,
        residual_dtype)
