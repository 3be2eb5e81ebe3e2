"""Bottlenecks wider than the port's defaults: ``dim_neck_3`` = 40 (the
multi-stream kernels' block plans, widths 33-64) and 72 (past the
kernels' ``MAX_HIDDEN``: each encoder's own layer, as JAX's generator
runs it where its ``_fuse_encoder_group`` says no). Both models' eval
forward against the JAX package's at a tiny config (JAX's Pallas kernels
in interpret mode at B=8, at ``TEST_FOLD``), which route each width
takes, and the parameter names, which do not depend on it. The default
config's train steps are tests/test_torch_wide_neck_step.py's.

Bars: the eval forward at float32 within ``ATOL`` (5e-5) of JAX's, as
tests/test_torch_models.py holds the default widths.
"""

import dataclasses

import numpy as np
import pytest
import torch

from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.ops import bilstm, multi_bilstm
from tests.test_pallas_multilstm import _tiny_config
from tests.test_torch_compute_bf16 import interpret
from tests.test_torch_models import ATOL, _jax_params, _port

B = 8
NECKS = pytest.mark.parametrize("neck", [40, 72])


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def configs(neck: int, **fields):
    """The tiny config at ``dim_neck_3=neck``: JAX's and the port's."""
    jcfg = _tiny_config().replace(dim_neck_3=neck, **fields)
    return jcfg, SpeechSplitConfig(**dataclasses.asdict(jcfg))


def count_routes(monkeypatch):
    """Counts of the multi-stream call and of the merged layer's call
    while the block runs (``ops.multi_bilstm`` and ``ops.bilstm``
    attributes, which the models look up at each call)."""
    counts = {"multi_bilstm_sequence": 0, "bilstm_sequence": 0}
    for module, name in ((multi_bilstm, "multi_bilstm_sequence"),
                         (bilstm, "bilstm_sequence")):
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            counts[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    return counts


# the routes a forward takes: (multi-stream calls, merged layer calls).
# At 40: one multi-stream call, then content layer 1 and the decoder's
# layers (3 mel, 2 F0). At 72: each encoder layer on its own (content 0
# and 1, pitch, rhythm; f0, rhythm) beside the decoder's.
ROUTES = {("speechsplit", 40): (1, 4), ("speechsplit", 72): (0, 7),
          ("f0_converter", 40): (1, 2), ("f0_converter", 72): (0, 4)}


def test_fits_is_the_kernels_limits():
    assert multi_bilstm.fits((8, 64, 1))
    assert multi_bilstm.fits((64, 64, 64, 64))
    assert not multi_bilstm.fits((8, 65, 1))
    assert not multi_bilstm.fits((1,) * 5)  # 10 directions
    assert multi_bilstm.MAX_HIDDEN == 64 and multi_bilstm.MAX_DIRECTIONS == 8


@NECKS
def test_speechsplit_forward_matches_jax(monkeypatch, neck):
    jcfg, cfg = configs(neck)
    rng = np.random.RandomState(neck)
    x_f0 = rng.rand(B, cfg.max_len_pad, cfg.dim_freq + cfg.dim_f0).astype(
        np.float32)
    x_org = rng.rand(B, cfg.max_len_pad, cfg.dim_freq).astype(np.float32)
    c_trg = rng.rand(B, cfg.dim_spk_emb).astype(np.float32)
    jmodel = JaxSpeechSplit(jcfg)
    params = _jax_params(jmodel, x_f0, x_org, c_trg)
    want = np.asarray(jmodel.apply({"params": params}, x_f0, x_org, c_trg))
    model = _port(SpeechSplit, cfg, params, "speechsplit")
    counts = count_routes(monkeypatch)
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x_f0, x_org, c_trg)))
    assert (counts["multi_bilstm_sequence"],
            counts["bilstm_sequence"]) == ROUTES[("speechsplit", neck)]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert not any(multi_bilstm.LAUNCHES.values())


@NECKS
def test_f0_converter_forward_matches_jax(monkeypatch, neck):
    jcfg, cfg = configs(neck)
    rng = np.random.RandomState(neck + 1)
    x_org = rng.rand(B, cfg.max_len_pad, cfg.dim_freq).astype(np.float32)
    f0_trg = rng.rand(B, cfg.max_len_pad, cfg.dim_f0).astype(np.float32)
    jmodel = JaxF0Converter(jcfg)
    params = _jax_params(jmodel, x_org, f0_trg)
    want = np.asarray(jmodel.apply({"params": params}, x_org, f0_trg))
    model = _port(F0Converter, cfg, params, "f0_converter")
    counts = count_routes(monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(x_org), torch.from_numpy(f0_trg))
    assert (counts["multi_bilstm_sequence"],
            counts["bilstm_sequence"]) == ROUTES[("f0_converter", neck)]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("cls", [SpeechSplit, F0Converter])
def test_state_dict_keys_do_not_depend_on_the_route(cls):
    """The same parameter names and shapes at every width: 8 (the lane
    plans), 40 (the block plans) and 72 (each encoder's own layer); only
    the widths of the f0 and pitch layers change."""
    keys = {}
    for neck in (8, 40, 72):
        model = cls(configs(neck)[1], torch.Generator().manual_seed(0))
        keys[neck] = list(model.state_dict())
    assert keys[8] == keys[40] == keys[72]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_wide_routes_run_every_precision(compute):
    """Eval forwards at both widths, both compute dtypes and both residual
    dtypes run (on the CPU every route runs the plain versions the
    kernels are held to on the card), finite and of the float32 path's
    shape."""
    for neck in (40, 72):
        for residual in ("float32", "bfloat16"):
            _, cfg = configs(neck, compute_dtype=compute,
                             residual_dtype=residual)
            model = SpeechSplit(cfg, torch.Generator().manual_seed(2))
            rng = np.random.RandomState(3)
            x_org = torch.from_numpy(rng.rand(
                2, cfg.max_len_pad, cfg.dim_freq).astype(np.float32))
            x_f0 = torch.cat([x_org, torch.zeros(
                2, cfg.max_len_pad, cfg.dim_f0)], dim=-1)
            c_trg = torch.eye(cfg.dim_spk_emb)[:2]
            out = model(x_f0, x_org, c_trg)
            assert out.shape == (2, cfg.max_len_pad, cfg.dim_freq)
            assert torch.isfinite(out).all()
            out.sum().backward()
            assert all(torch.isfinite(p.grad).all()
                       for p in model.parameters())
