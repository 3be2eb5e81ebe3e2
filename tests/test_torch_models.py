"""The port's models against the JAX package's: eval forward at a tiny
config (weights carried by interop), exact parameter counts at the
default config, and state-dict keys and arrays bit-equal to the JAX
package's reference-format export."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu.interop import params_to_torch_state_dict
from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import jax_params_to_state_dict
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.ops import bilstm, multi_bilstm
from tests.jax_interpret import at_test_fold

TINY = dict(
    dim_enc=64, dim_enc_2=32, dim_enc_3=64,
    dim_neck=4, dim_neck_2=1, dim_neck_3=8,
    dim_dec_mel=64, dim_dec_f0=32,
    max_len_pad=32, max_len_seq=32, min_len_seq=16,
)
B, T = 8, 32
ATOL = 5e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """The JAX side runs its Pallas kernels in interpret mode (B >= 8
    takes the fused multi-stream path, as on the TPU)."""
    at_test_fold(monkeypatch)
    pallas_lstm.FORCE_INTERPRET = True
    prev = pallas_lstm.RESIDUAL_DTYPE
    pallas_lstm.RESIDUAL_DTYPE = jnp.float32
    yield
    pallas_lstm.FORCE_INTERPRET = False
    pallas_lstm.RESIDUAL_DTYPE = prev


def _jax_params(model, *inputs):
    rngs = {"params": jax.random.PRNGKey(0), "resample": jax.random.PRNGKey(1)}
    return model.init(rngs, *inputs)["params"]


def _port(cls, cfg, params, name):
    model = cls(cfg, torch.Generator().manual_seed(5)).eval()
    model.load_state_dict(jax_params_to_state_dict(params, name), strict=True)
    return model


def test_speechsplit_forward_matches_jax(rng):
    jcfg, cfg = JaxConfig(**TINY), SpeechSplitConfig(**TINY)
    x_f0 = rng.rand(B, T, cfg.dim_freq + cfg.dim_f0).astype(np.float32)
    x_org = rng.rand(B, T, cfg.dim_freq).astype(np.float32)
    c_trg = rng.rand(B, cfg.dim_spk_emb).astype(np.float32)
    jmodel = JaxSpeechSplit(jcfg)
    params = _jax_params(jmodel, x_f0, x_org, c_trg)
    want = np.asarray(jmodel.apply({"params": params}, x_f0, x_org, c_trg))
    model = _port(SpeechSplit, cfg, params, "speechsplit")
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (x_f0, x_org, c_trg)))
        rhythm = model.rhythm(torch.from_numpy(x_org))
    assert got.shape == (B, T, cfg.dim_freq)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    want_rhythm = jmodel.apply({"params": params}, x_org,
                               method=JaxSpeechSplit.rhythm)
    np.testing.assert_allclose(rhythm.numpy(), np.asarray(want_rhythm),
                               atol=ATOL)
    assert not any(bilstm.LAUNCHES.values())
    assert not any(multi_bilstm.LAUNCHES.values())


def test_f0_converter_forward_matches_jax(rng):
    jcfg, cfg = JaxConfig(**TINY), SpeechSplitConfig(**TINY)
    x_org = rng.rand(B, T, cfg.dim_freq).astype(np.float32)
    f0_trg = rng.rand(B, T, cfg.dim_f0).astype(np.float32)
    jmodel = JaxF0Converter(jcfg)
    params = _jax_params(jmodel, x_org, f0_trg)
    want = np.asarray(jmodel.apply({"params": params}, x_org, f0_trg))
    model = _port(F0Converter, cfg, params, "f0_converter")
    with torch.no_grad():
        got = model(torch.from_numpy(x_org), torch.from_numpy(f0_trg))
    assert got.shape == (B, T, cfg.dim_f0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_parameter_counts_at_default_config():
    cfg = SpeechSplitConfig()
    g = SpeechSplit(cfg, torch.Generator().manual_seed(0))
    p = F0Converter(cfg, torch.Generator().manual_seed(0))
    assert sum(x.numel() for x in g.parameters()) == 19_437_800
    assert sum(x.numel() for x in p.parameters()) == 3_485_849


@pytest.mark.parametrize("name", ["speechsplit", "f0_converter"])
def test_state_dict_matches_jax_export(rng, name):
    jcfg, cfg = JaxConfig(**TINY), SpeechSplitConfig(**TINY)
    x_org = np.zeros((1, T, cfg.dim_freq), np.float32)
    if name == "speechsplit":
        jmodel, cls = JaxSpeechSplit(jcfg), SpeechSplit
        inputs = (np.zeros((1, T, cfg.dim_freq + cfg.dim_f0), np.float32),
                  x_org, np.zeros((1, cfg.dim_spk_emb), np.float32))
    else:
        jmodel, cls = JaxF0Converter(jcfg), F0Converter
        inputs = (x_org, np.zeros((1, T, cfg.dim_f0), np.float32))
    params = _jax_params(jmodel, *inputs)
    exported = params_to_torch_state_dict(params, name)
    ours = jax_params_to_state_dict(params, name)
    model_keys = list(cls(cfg, torch.Generator()).state_dict())
    assert sorted(model_keys) == sorted(exported) == sorted(ours)
    for key, value in exported.items():
        np.testing.assert_array_equal(ours[key].numpy(), value)


def test_reference_len_org_buffers_load_strictly():
    """Reference checkpoints carry constant len_org buffers in encoder_1
    (Generator_3) and encoder_3 (Generator_6); strict loading drops them."""
    cfg = SpeechSplitConfig(**TINY)
    for cls, prefix in ((SpeechSplit, "encoder_1"), (F0Converter, "encoder_3")):
        model = cls(cfg, torch.Generator().manual_seed(1))
        state = dict(model.state_dict())
        state[f"{prefix}.len_org"] = torch.tensor(cfg.max_len_pad)
        model.load_state_dict(state, strict=True)
        state["decoder.unknown"] = torch.zeros(1)
        with pytest.raises(RuntimeError, match="Unexpected"):
            model.load_state_dict(state, strict=True)


def test_interop_rejects_unmapped_subtrees():
    jcfg = JaxConfig(**TINY)
    x_org = np.zeros((1, T, jcfg.dim_freq), np.float32)
    params = dict(_jax_params(
        JaxF0Converter(jcfg), x_org, np.zeros((1, T, jcfg.dim_f0), np.float32)
    ))
    params["speaker_encoder"] = {"proj": {"kernel": np.zeros((2, 2))}}
    with pytest.raises(ValueError, match="no reference counterpart"):
        jax_params_to_state_dict(params, "f0_converter")


def test_training_and_learned_mode_are_later_slices():
    """Train mode is ported and needs a generator for its resampling
    draws; learned mode builds a speaker encoder (an unknown mode
    raises); bfloat16 compute builds its layers at bfloat16 with float32
    parameters, and a dtype without a JAX counterpart raises."""
    cfg = SpeechSplitConfig(**TINY)
    model = SpeechSplit(cfg, torch.Generator())
    x = torch.zeros(1, T, cfg.dim_freq + cfg.dim_f0)
    with pytest.raises(ValueError, match="Generator"):
        model(x, x[..., : cfg.dim_freq], torch.zeros(1, cfg.dim_spk_emb),
              train=True)
    with pytest.raises(ValueError, match="Generator"):
        F0Converter(cfg, torch.Generator())(
            x[..., : cfg.dim_freq], x[..., cfg.dim_freq :], train=True)
    learned = SpeechSplit(cfg.replace(spk_emb_mode="learned"))
    assert hasattr(learned, "speaker_encoder")
    assert not hasattr(model, "speaker_encoder")
    with pytest.raises(ValueError, match="spk_emb_mode"):
        SpeechSplit(cfg.replace(spk_emb_mode="xvector"))
    b16 = F0Converter(cfg.replace(compute_dtype="bfloat16"))
    assert b16.decoder.lstm.dtype == torch.bfloat16
    assert b16.encoder_3.convolutions[0][0].dtype == torch.bfloat16
    assert {p.dtype for p in b16.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="dtype"):
        F0Converter(cfg.replace(compute_dtype="float16"))
