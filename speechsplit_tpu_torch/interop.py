"""Checkpoint interop for the port.

The port's ``state_dict()`` keys are the reference's torch names
(reference model.py), so a reference ``.ckpt`` (``660000-G.ckpt``,
``640000-P.ckpt``) and a ``.ckpt`` exported by the JAX package
(``speechsplit_tpu.cli.export_ckpt``) both load with
``load_state_dict(strict=True)`` as they are.

:func:`jax_params_to_state_dict` carries a JAX/flax parameter tree, given
as numpy arrays, into that state dict; it is the port's own copy of the
JAX package's ``interop.params_to_torch_state_dict`` mapping (its
interop.py:60-103 module maps and :180-239 layout rules):

- Linear: flax ``kernel [in, out]``       -> torch ``weight [out, in]``
- Conv1d: flax ``kernel [k, in, out]``    -> torch ``weight [out, in, k]``
- GroupNorm: ``scale``/``bias``           -> ``weight``/``bias``
- LSTM: ``w_ih_l{k}[I, 4H]`` etc.         -> ``weight_ih_l{k}[4H, I]``;
  both bias vectors are kept.

A learned-mode generator (``spk_emb_mode="learned"``) also holds the
JAX ``speaker_encoder`` subtree, which has no reference counterpart; it
maps to keys of the port's own under ``speaker_encoder.``:

- ``conv_{i}/kernel [5, in, out]``, ``conv_{i}/bias`` (i = 0, 1, 2) ->
  ``speaker_encoder.conv_{i}.conv.weight [out, in, 5]``, ``.conv.bias``;
- ``scale_{i}``, ``bias_{i}`` [C] -> ``speaker_encoder.scale_{i}``,
  ``speaker_encoder.bias_{i}``;
- ``proj/kernel [2C, E]``, ``proj/bias`` ->
  ``speaker_encoder.proj.linear_layer.weight [E, 2C]``, ``.bias``.

So a learned ``.ckpt`` holds those keys beside the reference's and loads
strictly only into a learned-mode model; a one-hot tree maps as before.

:func:`jax_adam_state_to_torch` carries optax's Adam moments the same
way, so a JAX train state can go on training in the port.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _module_map_generator() -> Dict[str, tuple]:
    """torch submodule prefix -> (flax path, kind), Generator_3."""
    out: Dict[str, tuple] = {}
    for i in range(3):
        out[f"encoder_1.convolutions_1.{i}.0.conv"] = (
            ["encoder_content_pitch", f"conv_mel_{i}"], "conv")
        out[f"encoder_1.convolutions_1.{i}.1"] = (
            ["encoder_content_pitch", f"norm_mel_{i}"], "norm")
        out[f"encoder_1.convolutions_2.{i}.0.conv"] = (
            ["encoder_content_pitch", f"conv_f0_{i}"], "conv")
        out[f"encoder_1.convolutions_2.{i}.1"] = (
            ["encoder_content_pitch", f"norm_f0_{i}"], "norm")
    out["encoder_1.lstm_1"] = (["encoder_content_pitch", "lstm_content"],
                               "lstm")
    out["encoder_1.lstm_2"] = (["encoder_content_pitch", "lstm_pitch"], "lstm")
    out["encoder_2.convolutions.0.0.conv"] = (["encoder_rhythm", "conv_0"],
                                              "conv")
    out["encoder_2.convolutions.0.1"] = (["encoder_rhythm", "norm_0"], "norm")
    out["encoder_2.lstm"] = (["encoder_rhythm", "lstm"], "lstm")
    out["decoder.lstm"] = (["decoder", "lstm"], "lstm")
    out["decoder.linear_projection.linear_layer"] = (
        ["decoder", "projection"], "linear")
    return out


def _speaker_encoder_arrays(node: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The JAX ``speaker_encoder`` subtree -> the port's
    ``speaker_encoder.`` keys (the module docstring's table)."""
    out = {}
    for i in range(3):
        conv = _node(node, [f"conv_{i}"])
        out[f"speaker_encoder.conv_{i}.conv.weight"] = _array(
            conv["kernel"]).transpose(2, 1, 0)
        out[f"speaker_encoder.conv_{i}.conv.bias"] = _array(conv["bias"])
        for name in (f"scale_{i}", f"bias_{i}"):
            if name not in node:
                raise ValueError(f"speaker_encoder params miss {name!r}")
            out[f"speaker_encoder.{name}"] = _array(node[name])
    proj = _node(node, ["proj"])
    out["speaker_encoder.proj.linear_layer.weight"] = _array(proj["kernel"]).T
    out["speaker_encoder.proj.linear_layer.bias"] = _array(proj["bias"])
    return out


def _module_map_f0_converter() -> Dict[str, tuple]:
    """torch submodule prefix -> (flax path, kind), Generator_6."""
    out: Dict[str, tuple] = {}
    out["encoder_2.convolutions.0.0.conv"] = (["encoder_rhythm", "conv_0"],
                                              "conv")
    out["encoder_2.convolutions.0.1"] = (["encoder_rhythm", "norm_0"], "norm")
    out["encoder_2.lstm"] = (["encoder_rhythm", "lstm"], "lstm")
    for i in range(3):
        out[f"encoder_3.convolutions.{i}.0.conv"] = (
            ["encoder_f0", f"conv_{i}"], "conv")
        out[f"encoder_3.convolutions.{i}.1"] = (
            ["encoder_f0", f"norm_{i}"], "norm")
    out["encoder_3.lstm"] = (["encoder_f0", "lstm"], "lstm")
    out["decoder.lstm"] = (["decoder", "lstm"], "lstm")
    out["decoder.linear_projection.linear_layer"] = (
        ["decoder", "projection"], "linear")
    return out


_MODULE_MAPS = {
    "speechsplit": _module_map_generator,
    "f0_converter": _module_map_f0_converter,
}

_LSTM_RE = re.compile(r"(w|b)_(ih|hh)_l(\d+)(_reverse)?$")


def _node(tree: Mapping[str, Any], path: list[str]) -> Mapping[str, Any]:
    node: Any = tree
    for part in path:
        if part not in node:
            raise ValueError(f"params missing expected module {'/'.join(path)!r}")
        node = node[part]
    return node


def _array(value) -> np.ndarray:
    """A leaf widened to float32 in numpy (exact for a bfloat16 leaf, an
    ``ml_dtypes`` array that ``torch.from_numpy`` does not take)."""
    return np.array(value, dtype=np.float32, copy=True)


def _tree_dtype(tree) -> torch.dtype:
    """bfloat16 if any leaf of a numpy tree is bfloat16, else float32."""
    if isinstance(tree, Mapping):
        dtypes = {_tree_dtype(v) for v in tree.values()}
        return torch.bfloat16 if torch.bfloat16 in dtypes else torch.float32
    is_bf16 = np.asarray(tree).dtype.name == "bfloat16"
    return torch.bfloat16 if is_bf16 else torch.float32


def _lstm_arrays(node: Mapping[str, Any],
                 prefix: str) -> Dict[str, np.ndarray]:
    """A flax LSTM's ``w_ih_l0``, ``b_hh_l0_reverse``, ... -> torch's
    ``{prefix}weight_ih_l0``, ``{prefix}bias_hh_l0_reverse``, ...; the
    weights transposed to torch's [4H, I] / [4H, H]."""
    out = {}
    for name in node:
        m = _LSTM_RE.match(name)
        if not m:
            raise ValueError(f"unrecognized LSTM param {name!r} at {prefix!r}")
        kind_c, side, layer, rev = m.groups()
        suffix = f"l{layer}" + (rev or "")
        arr = _array(node[name])
        if kind_c == "w":
            out[f"{prefix}weight_{side}_{suffix}"] = arr.T
        else:
            out[f"{prefix}bias_{side}_{suffix}"] = arr
    return out


def lstm_params_to_state_dict(
    params: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """One JAX ``models.layers.LSTM``'s params (numpy leaves) -> the state
    dict of the port's ``LSTM`` of the same shape, uni- or bidirectional
    (``torch.nn.LSTM``'s names)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in _lstm_arrays(params, "").items()}


def jax_params_to_state_dict(
    params: Mapping[str, Any], model: str = "speechsplit"
) -> Dict[str, torch.Tensor]:
    """A flax params tree (numpy leaves) -> the port's state dict.

    ``model`` is ``"speechsplit"`` or ``"f0_converter"``. A generator's
    ``speaker_encoder`` subtree (learned mode) maps to the port's
    ``speaker_encoder.`` keys; any other subtree with no reference
    counterpart raises.
    """
    params = params.get("params", params)
    if model not in _MODULE_MAPS:
        raise ValueError(f"unknown model {model!r}")
    out: Dict[str, np.ndarray] = {}
    consumed = set()
    for prefix, (path, kind) in _MODULE_MAPS[model]().items():
        node = _node(params, path)
        consumed.add(tuple(path))
        if kind == "conv":
            out[prefix + ".weight"] = _array(node["kernel"]).transpose(2, 1, 0)
            out[prefix + ".bias"] = _array(node["bias"])
        elif kind == "norm":
            out[prefix + ".weight"] = _array(node["scale"])
            out[prefix + ".bias"] = _array(node["bias"])
        elif kind == "linear":
            out[prefix + ".weight"] = _array(node["kernel"]).T
            out[prefix + ".bias"] = _array(node["bias"])
        else:
            out.update(_lstm_arrays(node, prefix + "."))
    if model == "speechsplit" and "speaker_encoder" in params:
        out.update(_speaker_encoder_arrays(params["speaker_encoder"]))
        consumed.update(("speaker_encoder", f"{name}_{i}")
                        for name in ("conv", "scale", "bias")
                        for i in range(3))
        consumed.add(("speaker_encoder", "proj"))
    extra = {
        f"{top}/{name}"
        for top, sub in params.items()
        for name in (sub if isinstance(sub, Mapping) else [None])
        if (top, name) not in consumed
    }
    if extra:
        raise ValueError(
            f"params contain subtrees with no reference counterpart: "
            f"{sorted(extra)}"
        )
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a reference-format ``.ckpt`` (``{'model': sd}``
    as the reference's solver.py:198-202 writes, or a bare state dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["model"] if "model" in ckpt else ckpt


def save_reference_checkpoint(module: torch.nn.Module, path: str) -> None:
    """Save a model as a reference-loadable ``.ckpt`` (``{'model': sd}``)."""
    state = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
    torch.save({"model": state}, path)


def _adam_fields(opt_state) -> tuple:
    """(count, mu, nu) of an optax Adam state: a ``ScaleByAdamState``,
    or a chain's tuple that holds one."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            try:
                return _adam_fields(part)
            except ValueError:
                continue
    raise ValueError("no Adam state (count, mu, nu) in the optimizer state")


def jax_adam_state_to_torch(
    opt_state, name: str, optimizer: torch.optim.Optimizer,
    model: torch.nn.Module,
) -> None:
    """Carry an optax Adam state (numpy leaves) into torch Adam.

    ``opt_state`` holds ``count``, ``mu`` and ``nu`` (optax's
    ``ScaleByAdamState``, alone or inside ``optax.adam``'s chain state);
    ``mu`` and ``nu`` are trees shaped like the flax params of model
    ``name`` (``"speechsplit"`` or ``"f0_converter"``; a learned-mode
    generator's with its ``speaker_encoder`` subtree), so they take the
    layout rules of :func:`jax_params_to_state_dict`. ``optimizer`` is an
    Adam over ``model``'s parameters (torch's, or the port's
    ``training.train_step.Adam``); each parameter's state becomes
    ``step`` (= count), ``exp_avg`` (= mu, in mu's dtype: bfloat16 under
    ``adam_mu_dtype="bfloat16"``, widened in numpy and narrowed again,
    both exact) and ``exp_avg_sq`` (= nu), on the parameter's device.
    With the parameters carried by
    :func:`jax_params_to_state_dict`, the next torch step continues the
    JAX run's Adam update (the same bias corrections: optax's count and
    torch's step both count updates already made).
    """
    count, mu, nu = _adam_fields(opt_state)
    exp_avg = jax_params_to_state_dict(mu, name)
    exp_avg_sq = jax_params_to_state_dict(nu, name)
    mu_dtype = _tree_dtype(mu.get("params", mu) if isinstance(mu, Mapping)
                           else mu)
    step = float(np.asarray(count))
    params = dict(model.named_parameters())
    owned = {id(p) for group in optimizer.param_groups
             for p in group["params"]}
    if sorted(params) != sorted(exp_avg):
        raise ValueError("the Adam state's tree does not match the model's "
                         "parameters")
    for key, param in params.items():
        if id(param) not in owned:
            raise ValueError(f"{key} is not a parameter of the optimizer")
        optimizer.state[param] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": exp_avg[key].to(param.device, mu_dtype),
            "exp_avg_sq": exp_avg_sq[key].to(param.device, param.dtype),
        }
