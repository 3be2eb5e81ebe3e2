"""Core layers of the port (counterpart of speechsplit_tpu/models/layers.py).

- Public layouts are ``[B, T, C]`` as in the JAX package; the
  recurrences run time-major ``[T, B, 4H]`` streams through the kernels
  of ``ops.bilstm`` / ``ops.multi_bilstm``, or one direction a launch
  through ``ops.lstm``.
- Parameter names follow the reference's torch modules (ConvNorm.conv,
  LinearNorm.linear_layer, nn.LSTM's ``weight_ih_l{k}[_reverse]``, ...),
  so reference and JAX-exported ``.ckpt`` files load with
  ``load_state_dict(strict=True)``.
- Every initializer takes an explicit ``torch.Generator`` and draws the
  distributions of the JAX package (gain-scaled Xavier for Linear and
  Conv1d weights, U(+-1/sqrt(fan_in)) biases, U(+-1/sqrt(H)) for LSTMs).
  Parameters are created on the CPU; move the module with ``.to``.
- The input projection ``x W_ih^T + b_ih + b_hh`` stays a matmul outside
  the kernels, as it stays outside the Pallas kernels in JAX, unless
  ``ops.bilstm.PROJ_FUSION = "auto"`` moves it into the kernel.
- ``dtype`` (``config.compute_dtype``) is the JAX layers' field: the
  parameters stay float32 and bfloat16 is a cast at each use. A
  ``Linear`` (and an LSTM's projection) multiplies x and W rounded to
  bfloat16 with a float32 sum, then adds the bias; a ``Conv1d`` rounds
  x, W and its output to bfloat16, then adds the bias in float32 (JAX
  layers.py:77-135); an LSTM's W_hh is bfloat16 from H = 2
  (``_recurrent_dtype``). The rounded operands go through float32
  products, which are exact for bfloat16 values (in TF32 too), so no
  bfloat16 GEMM rounds a result JAX keeps in float32; the backward of
  the casts rounds the weights' and inputs' gradients to bfloat16, as
  JAX's transpose of its mixed products does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from speechsplit_tpu_torch.ops import bilstm, lstm

GAIN = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0}


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``x W^T + b`` at compute ``dtype``: at bfloat16 JAX's
    ``jnp.dot(x, W, preferred_element_type=float32) + b``, the product of
    rounded operands summed in float32 and the bias added after it (x
    may be bfloat16 already: a recurrence's h under
    ``H_STREAM_FOLLOWS_COMPUTE``)."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    return F.linear(bilstm.operand(x.float(), dtype),
                    bilstm.operand(weight, dtype)) + bias


def _uniform(shape, bound: float, generator: torch.Generator) -> nn.Parameter:
    data = torch.empty(shape, dtype=torch.float32)
    data.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(data)


def _xavier(shape, fan_in: int, fan_out: int, gain: str,
            generator: torch.Generator) -> nn.Parameter:
    bound = GAIN[gain] * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(shape, bound, generator)


class _Params(nn.Module):
    """A bare holder of ``weight``/``bias``, named like the reference's
    wrapped ``nn.Linear`` / ``nn.Conv1d`` so state-dict keys match."""

    def __init__(self, weight: nn.Parameter, bias: nn.Parameter):
        super().__init__()
        self.weight = weight
        self.bias = bias


class Linear(nn.Module):
    """Dense layer on the last axis (ref LinearNorm, model.py:10-20)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator, w_init_gain: str = "linear",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        weight = _xavier((out_features, in_features), in_features,
                         out_features, w_init_gain, generator)
        bias = _uniform((out_features,), 1.0 / math.sqrt(in_features),
                        generator)
        self.linear_layer = _Params(weight, bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(x, self.linear_layer.weight, self.linear_layer.bias,
                      self.dtype)


class Conv1d(nn.Module):
    """'Same'-padded 1-D convolution over [B, T, C] (ref ConvNorm,
    model.py:24-42; padding as layers.py:117)."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: torch.Generator, kernel_size: int = 1,
                 dilation: int = 1, w_init_gain: str = "linear",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("even kernels need explicit padding")
        weight = _xavier((out_channels, in_channels, kernel_size),
                         in_channels * kernel_size,
                         out_channels * kernel_size, w_init_gain, generator)
        bias = _uniform((out_channels,),
                        1.0 / math.sqrt(in_channels * kernel_size), generator)
        self.conv = _Params(weight, bias)
        self.dilation = dilation
        self.padding = dilation * (kernel_size - 1) // 2
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            y = F.conv1d(x.transpose(1, 2), self.conv.weight, self.conv.bias,
                         padding=self.padding, dilation=self.dilation)
            return y.transpose(1, 2)
        # a bfloat16 conv emits bfloat16 and the bias goes on after the
        # widening (JAX layers.py:124-135)
        y = F.conv1d(bilstm.operand(x, self.dtype).transpose(1, 2),
                     bilstm.operand(self.conv.weight, self.dtype), None,
                     padding=self.padding, dilation=self.dilation)
        return bilstm.operand(y.transpose(1, 2), self.dtype) + self.conv.bias


class GroupNorm(nn.Module):
    """Group normalization over the channels of [B, T, C], statistics per
    (batch, group) across time and the group's channels (torch
    nn.GroupNorm semantics, as the JAX layer computes them)."""

    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError("channels must divide into groups")
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        xg = x.float().reshape(b, t, self.num_groups, -1)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        xg = (xg - mean) * torch.rsqrt(var + self.epsilon)
        return xg.reshape(b, t, c) * self.weight + self.bias


def conv_norm(in_channels: int, out_channels: int, groups: int,
              generator: torch.Generator,
              dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """Conv1d(k5, relu gain) at compute ``dtype`` + GroupNorm (float32
    throughout): one reference ``convolutions[i]`` entry (``.0.conv`` and
    ``.1`` keys)."""
    return nn.Sequential(
        Conv1d(in_channels, out_channels, generator, kernel_size=5,
               w_init_gain="relu", dtype=dtype),
        GroupNorm(groups, out_channels),
    )


def _recurrent_dtype(dtype: torch.dtype, hidden: int) -> torch.dtype:
    """Dtype of an H-wide LSTM's recurrent weights: bfloat16 applies only
    from H >= 2 (JAX layers.py:165-176), so the H=1 rhythm stream stays
    float32."""
    if dtype == torch.bfloat16 and hidden < 2:
        return torch.float32
    return dtype


class LSTM(nn.Module):
    """Multi-layer (bi)directional LSTM with torch's parameter names.

    Per layer and direction: ``weight_ih_l{k}`` [4H, I], ``weight_hh_l{k}``
    [4H, H], ``bias_ih_l{k}``, ``bias_hh_l{k}`` [4H], and for a
    bidirectional stack the same with ``_reverse``, as ``torch.nn.LSTM``
    declares them. Returns [B, T, D*H] (forward and backward halves
    concatenated), as all five reference LSTM stacks consume (every LSTM
    of the model is bidirectional).

    Routes of a layer (the JAX layer's, layers.py:331-425): a
    bidirectional layer whose shape ``ops.bilstm.merged_bidir_fits`` runs
    both directions in one merged launch, in JAX's order: fused where
    ``ops.bilstm.fused_proj_plan`` approves, else ``ops.bilstm.
    bilstm_layer`` where ``ops.bilstm.LAYER_VJP`` is "on", else composed
    (the projection, then ``bilstm_sequence``); a unidirectional layer,
    or a bidirectional one whose batch the merged kernels cannot hold,
    runs ``ops.lstm.lstm_sequence`` once per direction on ``F.linear(x,
    W_ih, b)``.

    ``residual_dtype`` (float32 or bfloat16; the JAX layer's field of
    the same name, threaded from ``config.residual_dtype``; None, the
    default, is ``ops.bilstm.RESIDUAL_DTYPE``, bfloat16, as in JAX) is
    the dtype the layer's recurrences save their residuals in under
    autograd. In eval and under ``no_grad`` nothing is saved and it
    changes nothing but the xp and h streams' dtypes below. Every route
    runs it in every kernel: the merged ones, composed or fused, and the
    single-direction one. h leaves each recurrence in
    ``ops.bilstm._h_stream_dtype`` (bfloat16 only under
    ``H_STREAM_FOLLOWS_COMPUTE`` at bfloat16 compute and residuals).

    ``dtype`` (``config.compute_dtype``): the projections follow
    ``Linear``, W_hh is cast to ``_recurrent_dtype`` at each use, and on
    the composed merged and the single-direction routes the projected
    inputs are cast to ``ops.bilstm.stream_dtype`` (bfloat16 where W_hh
    and the residuals both are), as the JAX layer casts them
    (layers.py:208-217). The fused route takes x and W_ih cast to W_hh's
    dtype, as the JAX layer's fused call does (layers.py:367-375), and
    projects inside the kernel in float32 sums. bfloat16 compute runs
    every route and ``streams``.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 bidirectional: bool = True,
                 residual_dtype: torch.dtype | None = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
        self.residual_dtype = bilstm._resolve_residual(residual_dtype)
        self.bidirectional = bidirectional
        k = 1.0 / math.sqrt(hidden_size)
        four_h = 4 * hidden_size
        for layer in range(num_layers):
            in_features = input_size if layer == 0 else (
                (2 if bidirectional else 1) * hidden_size)
            for sfx in self._suffixes(layer):
                setattr(self, f"weight_ih_{sfx}",
                        _uniform((four_h, in_features), k, generator))
                setattr(self, f"weight_hh_{sfx}",
                        _uniform((four_h, hidden_size), k, generator))
                setattr(self, f"bias_ih_{sfx}",
                        _uniform((four_h,), k, generator))
                setattr(self, f"bias_hh_{sfx}",
                        _uniform((four_h,), k, generator))

    def _suffixes(self, layer: int):
        if self.bidirectional:
            return f"l{layer}", f"l{layer}_reverse"
        return (f"l{layer}",)

    def _input_weights(self, sfx: str):
        """``(weight_ih [4H, I], b_ih + b_hh [4H])`` of one direction."""
        bias = getattr(self, f"bias_ih_{sfx}") + getattr(self, f"bias_hh_{sfx}")
        return getattr(self, f"weight_ih_{sfx}"), bias

    def _project(self, x: torch.Tensor, sfx: str) -> torch.Tensor:
        """``x W_ih^T + b`` at the layer's compute dtype (``Linear``'s
        rounding), float32."""
        return _dense(x, *self._input_weights(sfx), self.dtype)


    def _w_hh(self, sfx: str) -> torch.Tensor:
        w = getattr(self, f"weight_hh_{sfx}")
        return w.to(_recurrent_dtype(self.dtype, self.hidden_size))

    def _direction(self, x: torch.Tensor, sfx: str) -> torch.Tensor:
        """One direction of a layer over time-major x [T, B, I] through
        ``ops.lstm``: h [T, B, H] in real time order, the projection in
        the stream dtype (JAX's ``_lstm_direction``, layers.py:215-217)."""
        w = self._w_hh(sfx)
        sd = bilstm.stream_dtype(w.dtype, self.residual_dtype)
        return lstm.lstm_sequence(self._project(x, sfx).to(sd).contiguous(),
                                  w, sfx.endswith("_reverse"),
                                  self.residual_dtype)

    def streams(self, x: torch.Tensor, layer: int = 0):
        """Layer ``layer``'s kernel-ready streams without running it:
        ``(xp_f [T,B,4H], xp_b [T,B,4H], w_f [4H,H], w_b [4H,H])`` for
        ``ops.multi_bilstm.multi_bilstm_sequence``; x is [B, T, I]."""
        if not self.bidirectional:
            raise ValueError("streams mode is for BiLSTM layers")
        xt = x.transpose(0, 1)
        sfx = f"l{layer}"
        return (
            self._project(xt, sfx).contiguous(),
            self._project(xt, sfx + "_reverse").contiguous(),
            self._w_hh(sfx),
            self._w_hh(sfx + "_reverse"),
        )

    def forward(self, x: torch.Tensor, mode: str = "run",
                start_layer: int = 0):
        """mode="run": layers ``start_layer..num_layers-1`` over x [B, T, I]
        -> [B, T, D*H]. mode="streams": :meth:`streams` of ``start_layer``
        (the JAX layer's mode of the same name)."""
        if mode == "streams":
            return self.streams(x, start_layer)
        if mode != "run":
            raise ValueError(f"unknown LSTM mode {mode!r}")
        x = x.transpose(0, 1)  # the whole stack runs time-major
        t_len, batch = x.shape[:2]
        # the merged kernels under autograd include the gradient kernel,
        # whose batch limit is lower
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        merged = self.bidirectional and bilstm.merged_bidir_fits(
            t_len, batch, self.hidden_size, grad=grad)
        for layer in range(start_layer, self.num_layers):
            if not merged:
                # one direction a launch (the JAX layer's layers.py:405-425)
                x = torch.cat([self._direction(x, sfx)
                               for sfx in self._suffixes(layer)], dim=-1)
                continue
            sfx_f, sfx_b = self._suffixes(layer)
            wi_f, b_f = self._input_weights(sfx_f)
            wi_b, b_b = self._input_weights(sfx_b)
            w_f, w_b = self._w_hh(sfx_f), self._w_hh(sfx_b)
            # fused, the layer VJP or composed (the JAX layer's
            # layers.py:359-401); all three compute the same forward sums
            wd = w_f.dtype
            if bilstm.fused_proj_plan(t_len, batch, self.hidden_size,
                                      x.shape[-1], wd):
                # the projection inside the kernel: no [T, B, 4H] stream;
                # x and W_ih in W_hh's dtype
                h_f, h_b = bilstm.bilstm_sequence_fused(
                    x.to(wd).contiguous(), wi_f.to(wd), wi_b.to(wd), b_f,
                    b_b, w_f, w_b, self.residual_dtype)
            elif bilstm.LAYER_VJP == "on":
                # projection and recurrence in one Function: its backward
                # forms dW_ih and dx at the residual dtype
                h_f, h_b = bilstm.bilstm_layer(
                    x.to(wd).contiguous(), wi_f.to(wd), wi_b.to(wd), b_f,
                    b_b, w_f, w_b, self.residual_dtype)
            else:
                sd = bilstm.stream_dtype(w_f.dtype, self.residual_dtype)
                h_f, h_b = bilstm.bilstm_sequence(
                    self._project(x, sfx_f).to(sd).contiguous(),
                    self._project(x, sfx_b).to(sd).contiguous(), w_f, w_b,
                    self.residual_dtype)
            x = torch.cat([h_f, h_b], dim=-1)
        return x.transpose(0, 1)


def downsample_codes(outputs: torch.Tensor, dim_neck: int,
                     freq: int) -> torch.Tensor:
    """Stride-``freq`` bottleneck sampling of BiLSTM outputs: forward
    states at t = freq-1 (mod freq), backward at t = 0 (mod freq)
    (ref: model.py:87,137-138,223-227). [B, T, 2n] -> [B, ceil, 2n]."""
    fwd = outputs[:, freq - 1 :: freq, :dim_neck]
    bwd = outputs[:, ::freq, dim_neck:]
    return torch.cat([fwd, bwd], dim=-1)


def upsample_codes(codes: torch.Tensor, freq: int) -> torch.Tensor:
    """Repeat-interleave codes back to frame rate (ref: model.py:301-306)."""
    return torch.repeat_interleave(codes, freq, dim=1)


def combine_bidir(h_f: torch.Tensor, h_b: torch.Tensor) -> torch.Tensor:
    """[T, B, H] direction streams (real time order) -> [B, T, 2H]."""
    return torch.cat([h_f, h_b], dim=-1).transpose(0, 1)
