"""Learned speaker mode in the port's models (``spk_emb_mode="learned"``):
the SpeakerEncoder and the generator with a mel as ``c_trg`` against the
JAX package's, at tests/test_speaker_encoder.py's small widths
(``dim_spk_enc=32``) and a 32-frame window, the weights carried by
``interop.jax_params_to_state_dict``; the SupCon loss; what interop
does with a learned tree.

Bars:
- the embedding at float32: 2e-5 absolute (unit-norm rows);
- at bfloat16 compute, PR 14's model bars (tests/test_torch_compute_bf16_
  models.py): the mean distance from JAX's bfloat16 embedding within a
  quarter of JAX's own bfloat16-to-float32 distance, the largest within
  2^-6;
- trailing zero padding: 1e-6, as the JAX package's own test;
- the eval forward with a rank-3 ``c_trg``: 5e-5 (PARITY.md's bar);
- ``speaker_contrastive_loss``: 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import (
    jax_adam_state_to_torch,
    jax_params_to_state_dict,
)
from speechsplit_tpu_torch.models import SpeechSplit
from speechsplit_tpu_torch.training import create_train_state
from speechsplit_tpu_torch.training.train_step import (
    speaker_contrastive_loss,
)
from tests.test_pallas_multilstm import _tiny_config

JCFG = _tiny_config().replace(spk_emb_mode="learned", dim_spk_enc=32)
CFG = SpeechSplitConfig(**dataclasses.asdict(JCFG))
T = CFG.max_len_pad
B = 4
EMB_ATOL = 2e-5
PAD_ATOL = 1e-6
FORWARD_ATOL = 5e-5
LOSS_ATOL = 1e-6
QUARTER = 0.25
ABS = 2.0 ** -6


def jax_learned_params(config=JCFG, seed=0):
    """A learned-mode JAX generator's params (a jitted init, a mel as
    ``c_trg`` so the speaker-encoder branch is created)."""
    rngs = {"params": jax.random.PRNGKey(seed),
            "resample": jax.random.PRNGKey(seed + 1)}
    return jax.jit(JaxSpeechSplit(config).init)(
        rngs, jnp.zeros((1, T, config.dim_freq + config.dim_f0)),
        jnp.zeros((1, T, config.dim_freq)),
        jnp.zeros((1, T, config.dim_freq)))["params"]


def port_model(params, config=CFG):
    model = SpeechSplit(config, torch.Generator())
    model.load_state_dict(jax_params_to_state_dict(params, "speechsplit"),
                          strict=True)
    return model.eval()


def padded_mels(seed, lengths=(9, 20, 31, T), t=T):
    """Mels in [0, 1) zeroed past each row's length, as the collator
    gives them."""
    rng = np.random.RandomState(seed)
    mel = rng.rand(len(lengths), t, CFG.dim_freq).astype(np.float32)
    for i, n in enumerate(lengths):
        mel[i, n:] = 0.0
    return mel


@pytest.fixture(scope="module")
def params():
    return jax_learned_params()


def _jax_embed(params, mel, config=JCFG, dtype=jnp.float32):
    """JAX's embedding, op by op as PR 14's bfloat16 tests run JAX: under
    one ``jax.jit`` XLA on the CPU rounds the bfloat16 products
    differently (measured: the port's mean distance from it 0.72 of
    JAX's own bfloat16-to-float32 distance, against under 0.25 eager)."""
    return np.asarray(JaxSpeechSplit(config, dtype=dtype).apply(
        {"params": params}, jnp.asarray(mel), method="embed_speaker"))


def test_embedding_matches_jax(params):
    mel = padded_mels(0)
    want = _jax_embed(params, mel)
    with torch.no_grad():
        got = port_model(params).embed_speaker(torch.from_numpy(mel)).numpy()
    assert got.shape == (len(mel), CFG.dim_spk_emb)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_embedding_bf16_rounds_like_jax(params):
    mel = padded_mels(1)
    want16 = _jax_embed(params, mel, JCFG.replace(compute_dtype="bfloat16"),
                        jnp.bfloat16)
    want32 = _jax_embed(params, mel)
    model = port_model(params, CFG.replace(compute_dtype="bfloat16"))
    assert model.speaker_encoder.conv_0.dtype == torch.bfloat16
    with torch.no_grad():
        got = model.embed_speaker(torch.from_numpy(mel)).numpy()
    assert got.dtype == np.float32
    ours = float(np.abs(got - want16).mean())
    theirs = float(np.abs(want16 - want32).mean())
    assert theirs > 0
    assert ours <= QUARTER * theirs, (ours, theirs)
    assert float(np.abs(got - want16).max()) <= ABS * float(
        np.abs(want16).max())


def test_embedding_ignores_trailing_zero_padding(params):
    mel = padded_mels(2, lengths=(25, 40), t=48)
    model = port_model(params)
    with torch.no_grad():
        short = model.embed_speaker(torch.from_numpy(mel))
        longer = model.embed_speaker(torch.from_numpy(
            np.pad(mel, ((0, 0), (0, 80), (0, 0)))))
    np.testing.assert_allclose(short.numpy(), longer.numpy(), rtol=0,
                               atol=PAD_ATOL)
    np.testing.assert_allclose(torch.linalg.norm(short, dim=-1).numpy(), 1.0,
                               atol=1e-5)


def test_forward_with_a_mel_as_c_trg_matches_jax(params):
    rng = np.random.RandomState(3)
    x_f0 = rng.rand(B, T, CFG.dim_freq + CFG.dim_f0).astype(np.float32)
    x_org = rng.rand(B, T, CFG.dim_freq).astype(np.float32)
    c_mel = padded_mels(4)
    want = jax.jit(JaxSpeechSplit(JCFG).apply)({"params": params}, x_f0,
                                               x_org, c_mel)
    model = port_model(params)
    inputs = [torch.from_numpy(a) for a in (x_f0, x_org, c_mel)]
    with torch.no_grad():
        got = model(*inputs)
        emb = model.embed_speaker(inputs[2])
        via_emb = model(inputs[0], inputs[1], emb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FORWARD_ATOL)
    torch.testing.assert_close(got, via_emb, rtol=0, atol=0)


def test_one_hot_model_refuses_a_mel_and_keeps_its_keys():
    onehot = CFG.replace(spk_emb_mode="onehot")
    model = SpeechSplit(onehot, torch.Generator())
    assert not any(k.startswith("speaker_encoder.")
                   for k in model.state_dict())
    x = torch.zeros(1, T, CFG.dim_freq + CFG.dim_f0)
    with pytest.raises(ValueError, match="spk_emb_mode='learned'"):
        model(x, x[..., : CFG.dim_freq], x[..., : CFG.dim_freq])
    with pytest.raises(ValueError, match="learned"):
        model.embed_speaker(x[..., : CFG.dim_freq])
    # the learned model's own parameters are the one-hot model's plus
    # the encoder's, and seeded alike
    learned = SpeechSplit(CFG, torch.Generator().manual_seed(0))
    same = SpeechSplit(onehot, torch.Generator().manual_seed(0))
    extra = {k for k in learned.state_dict()} - set(same.state_dict())
    assert extra == {f"speaker_encoder.{n}" for n in (
        *(f"conv_{i}.conv.{w}" for i in range(3) for w in ("weight", "bias")),
        *(f"{s}_{i}" for s in ("scale", "bias") for i in range(3)),
        "proj.linear_layer.weight", "proj.linear_layer.bias")}
    for key, value in same.state_dict().items():
        torch.testing.assert_close(learned.state_dict()[key], value, rtol=0,
                                   atol=0)
    with pytest.raises(ValueError, match="spk_emb_mode"):
        SpeechSplit(CFG.replace(spk_emb_mode="xvector"))


def test_speaker_contrastive_loss_matches_jax():
    rng = np.random.RandomState(5)
    emb = rng.randn(6, 16).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    # anchors 4 and 5 have no positive in the batch
    labels = np.array([3, 3, 7, 7, 1, 9])

    def loss_j(e):
        return jax_train_step.speaker_contrastive_loss(e, jnp.asarray(labels),
                                                       0.1)

    want, want_grad = jax.value_and_grad(loss_j)(jnp.asarray(emb))
    emb_t = torch.from_numpy(emb).requires_grad_()
    got = speaker_contrastive_loss(emb_t, torch.from_numpy(labels), 0.1)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=0,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=LOSS_ATOL)
    # no positive anywhere: guarded to 0, not NaN
    alone = speaker_contrastive_loss(torch.from_numpy(emb),
                                     torch.arange(6))
    assert float(alone) == 0.0


def test_learned_tree_carries_params_and_adam_state(params):
    """A learned tree maps strictly into a learned model only; its Adam
    state (optax's, after one update) carries into the port's Adam."""
    state_dict = jax_params_to_state_dict(params, "speechsplit")
    onehot = SpeechSplit(CFG.replace(spk_emb_mode="onehot"))
    with pytest.raises(RuntimeError, match="speaker_encoder"):
        onehot.load_state_dict(state_dict, strict=True)
    bad = dict(params, speaker_encoder=dict(params["speaker_encoder"],
                                            extra={"kernel": np.zeros(2)}))
    with pytest.raises(ValueError, match="speaker_encoder/extra"):
        jax_params_to_state_dict(bad, "speechsplit")
    tx = jax_train_step.make_optimizer(JCFG)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), params)
    _, opt_state = jax.jit(tx.update)(grads, tx.init(params), params)
    state = create_train_state(CFG, 0, device="cpu")
    jax_adam_state_to_torch(jax.tree.map(np.asarray, opt_state),
                            "speechsplit", state.optimizer, state.model)
    named = dict(state.model.named_parameters())
    conv = named["speaker_encoder.conv_1.conv.weight"]
    mu = state.optimizer.state[conv]["exp_avg"]
    assert mu.dtype == torch.bfloat16 and mu.shape == conv.shape
    np.testing.assert_allclose(mu.float().numpy(), 0.05, rtol=1e-2)
    assert float(state.optimizer.state[conv]["step"]) == 1.0
    assert len(state.optimizer.state) == len(named)
