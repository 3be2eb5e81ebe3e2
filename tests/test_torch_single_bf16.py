"""bfloat16 on the single-direction route: ``ops.lstm`` (its plain
versions and ``LSTMFunction`` on the CPU) at every dtype set the JAX
single route forms, against ``pallas_lstm``'s kernels in interpret mode;
``LSTM(bidirectional=False)`` at bfloat16 compute and at the default
config's float32 compute with bfloat16 residuals, against JAX's layer;
and the generator's eval forward, ``convert_batched`` and both train
steps with ``merged_bidir_fits`` patched to False in both packages, so
that every BiLSTM layer runs one ``lstm_sequence`` a direction, at
bfloat16 compute with the default config's bfloat16 residuals (bfloat16
W_hh, xp streams and residuals: every bfloat16 operand of the route).

JAX runs its Pallas kernels in interpret mode, its multi-stream kernels
at ``TEST_FOLD``; a whole JAX train step there still takes about half a
minute (eager, as the injected resampling draws need), which sets the
file's time: one step a model, at the config whose every operand is new
on this route.

The dtype sets (pallas_lstm.py:103-205, 487-567): W_hh float32 or
bfloat16 (bfloat16 compute: a step's product reads h_{t-1}, the
gradient's d_pre, rounded to bfloat16); residuals g and c float32 or
bfloat16, and with bfloat16 ones dh enters and dxp leaves in bfloat16;
xp bfloat16 exactly where W_hh and the residuals both are
(``stream_dtype``), and a lean call also takes a float32 xp beside a
bfloat16 W_hh. h is float32 throughout.

Bars, each stated where it is used (tests/test_torch_compute_bf16.py's,
which the merged route is held to):
- float32 outputs (h, a float32 dxp): 1e-5, absolute or relative to the
  largest magnitude where that is above 1; bfloat16 outputs (g, c, dxp):
  one bfloat16 ulp of the element plus float32 noise of 1e-6 of the
  largest magnitude; a Function's dxp two ulps;
- flips: at most 2% of a recurrence's outputs may miss those bars, and
  stay within 2^-8 of the largest magnitude (a rounded operand whose two
  float32 sums straddle a rounding boundary, carried by the steps after
  it);
- dW_hh: 2^-8 of its largest magnitude plus one bfloat16 ulp of the
  element;
- gradients of a layer or of a train step: 2% max-relative (PARITY.md
  #10); a step's loss 1e-4 relative (tests/test_torch_compute_bf16_step.py's
  bar);
- a model's outputs and the converted mels: 2^-7 of the largest
  magnitude (the flips above carried through every later layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu import convert as jconvert
from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu.models import F0Converter as JaxF0Converter
from speechsplit_tpu.models import SpeechSplit as JaxSpeechSplit
from speechsplit_tpu.models import layers as jl
from speechsplit_tpu.ops import interp as jax_interp
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu.training import train_step as jax_train_step
from speechsplit_tpu_torch import convert as tconvert
from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.interop import (
    jax_params_to_state_dict,
    lstm_params_to_state_dict,
)
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.models import layers as tl
from speechsplit_tpu_torch.ops import bilstm, lstm
from speechsplit_tpu_torch.training import (
    create_train_state,
    make_f0_train_step,
    make_train_step,
)
from tests.test_torch_compute_bf16 import (
    BF16,
    F32,
    _bf16_w,
    _jdt,
    _tdt,
    assert_dw_close,
    assert_flips_within,
    interpret,
)
from tests.test_torch_compute_bf16_step import _init
from tests.test_torch_convert import TINY, _pairs
from tests.test_torch_models import _jax_params, _port
from tests.test_torch_precision import DEF, JDEF, _batch8, _draws, _jax_step
from tests.test_torch_residual_bf16 import _f32, _t
from tests.test_torch_training import (  # noqa: F401 (gather_form: autouse)
    _inject,
    gather_form,
)

T, B = 12, 8  # B = 8: JAX's supported() takes its Pallas path
GRAD_TOL = 0.02
MODEL_TOL = 2.0 ** -7
LOSS_RTOL = 1e-4
RESIDUALS = pytest.mark.parametrize("rd", ["float32", "bfloat16"])
WIDTHS = pytest.mark.parametrize("h", [8, 64])
DIRECTIONS = pytest.mark.parametrize("reverse", [False, True])


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _single_route(monkeypatch):
    """Every BiLSTM layer on the single-direction route, in both
    packages."""
    for module in (bilstm, pallas_lstm):
        monkeypatch.setattr(module, "merged_bidir_fits",
                            lambda *args, **kwargs: False)
    monkeypatch.setattr(jax_interp, "FORCE_MATMUL", False)


def _inputs(h, seed):
    rng = np.random.RandomState(1800 + 7 * h + seed)
    xp = rng.randn(T, B, 4 * h).astype(np.float32)
    w = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)  # JAX layout
    dh = rng.randn(T, B, h).astype(np.float32)
    return xp, w, dh


def _weights(w, dtype: str):
    """A JAX-layout [h, 4h] weight as both packages' W_hh in ``dtype``."""
    if dtype == "bfloat16":
        return _bf16_w(w)
    return jnp.asarray(w), _t(w.T.copy())


def _stream(w_dtype: str, rd: str) -> str:
    return "bfloat16" if w_dtype == rd == "bfloat16" else "float32"


def _as(x, rd: str):
    """A stream as the dtype it was rounded to (bfloat16 values handed back
    in float32 compared at bfloat16's bars)."""
    if isinstance(x, torch.Tensor):
        return x.to(_tdt(rd))
    return jnp.asarray(x).astype(_jdt(rd))


@WIDTHS
@DIRECTIONS
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_lean_forward_bf16_w_matches_infer(h, reverse, stream):
    """The lean forward at a bfloat16 W_hh beside either xp stream against
    ``_infer``: h float32 at the flip bar."""
    xp, w, _ = _inputs(h, 1)
    jw, tw = _bf16_w(w)
    jxp = jnp.asarray(xp).astype(_jdt(stream))
    want = pallas_lstm._infer(jxp, jw, reverse=reverse)
    got = lstm.lstm_sequence(_t(_f32(jxp)).to(_tdt(stream)), tw, reverse)
    assert got.dtype == F32 and want.dtype == jnp.float32
    assert got.grad_fn is None
    assert_flips_within(got, want, "h")
    assert not any(lstm.LAUNCHES.values())


@WIDTHS
@DIRECTIONS
@RESIDUALS
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_forward_and_vjp_match_jax(h, reverse, rd, w_dtype):
    """At each (W_hh, residual) dtype pair, xp in its stream dtype: the
    residual-saving forward's plain version against ``_fwd`` (h, g, c),
    the gradient's against ``_bwd_call`` on ``_fwd``'s residuals (dh
    rounded to the residual dtype, dx in it), and ``LSTMFunction`` against
    the custom VJP's rules: h, dxp (in xp's dtype) and dW_hh (in W's)."""
    xp, w, dh = _inputs(h, 2)
    jw, tw = _weights(w, w_dtype)
    sd = _stream(w_dtype, rd)
    jxp = jnp.asarray(xp).astype(_jdt(sd))
    txp = _t(_f32(jxp)).to(_tdt(sd))
    want = pallas_lstm._fwd(jxp, jw, residual_dtype=_jdt(rd), reverse=reverse)
    got = lstm.lstm_direction_forward_reference(txp, tw, reverse, _tdt(rd))
    assert [g.dtype for g in got] == [F32, _tdt(rd), _tdt(rd)]
    for name, g, r in zip(("h", "g", "c"), got, want):
        assert_flips_within(g, r, name)
    jdh = jnp.asarray(dh).astype(_jdt(rd))
    want_dx = pallas_lstm._bwd_call(jdh, *want[1:], jw, reverse=reverse,
                                    dx_dtype=_jdt(rd))
    got_dx = lstm.lstm_direction_backward_reference(
        _t(_f32(jdh)).to(_tdt(rd)), *(_t(_f32(r)).to(_tdt(rd))
                                      for r in want[1:]), tw, reverse)
    assert got_dx.dtype == _tdt(rd)
    assert_flips_within(got_dx, want_dx, "dx")

    outs, res = pallas_lstm._vjp_fwd(jxp, jw, _jdt(rd), reverse)
    want_dxp, want_dw = pallas_lstm._vjp_bwd(_jdt(rd), reverse, res,
                                             jnp.asarray(dh))
    inputs = [txp.clone().requires_grad_(True),
              tw.clone().requires_grad_(True)]
    got_h = lstm.lstm_sequence(*inputs, reverse, _tdt(rd))
    assert type(got_h.grad_fn).__name__ == "LSTMFunctionBackward"
    got_dxp, got_dw = torch.autograd.grad(got_h, inputs, _t(dh))
    assert_flips_within(got_h, outs, "h")
    assert got_dxp.dtype == _tdt(sd) and want_dxp.dtype == _jdt(sd)
    assert got_dw.dtype == _tdt(w_dtype) and want_dw.dtype == _jdt(w_dtype)
    # dxp holds values of the residual dtype, in xp's
    assert_flips_within(_as(got_dxp, rd), _as(want_dxp, rd), "dxp", ulps=2)
    assert_dw_close(got_dw, _f32(want_dw).T, "dw")  # torch's [4H, H]
    assert not any(lstm.LAUNCHES.values())


@pytest.mark.parametrize("compute,rd", [("bfloat16", "bfloat16"),
                                        ("bfloat16", "float32"),
                                        ("float32", "bfloat16")])
def test_unidirectional_layer_matches_jax(compute, rd):
    """``LSTM(bidirectional=False)`` (2 layers) at bfloat16 compute (either
    residual dtype) and at the default config's float32 compute with
    bfloat16 residuals, against JAX's layer: the output at the flip bar,
    the gradients of x and of every parameter within 2% max-relative."""
    rng = np.random.RandomState(19)
    x = rng.randn(B, T, 12).astype(np.float32)
    ct = rng.randn(B, T, 16).astype(np.float32)
    mod = jl.LSTM(16, num_layers=2, bidirectional=False, dtype=_jdt(compute),
                  residual_dtype=_jdt(rd))
    params = mod.init(jax.random.PRNGKey(3), x)["params"]
    want, vjp = jax.vjp(lambda p, v: mod.apply({"params": p}, v), params,
                        jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(ct))
    ours = tl.LSTM(12, 16, 2, torch.Generator(), dtype=_tdt(compute),
                   bidirectional=False, residual_dtype=_tdt(rd))
    ours.load_state_dict(lstm_params_to_state_dict(params), strict=True)
    tx = _t(x).requires_grad_(True)
    got = ours(tx)
    got.backward(_t(ct))
    assert got.dtype == F32
    assert_flips_within(got, want, "y")
    grads = lstm_params_to_state_dict(jax.tree.map(np.asarray, dparams))
    for name, p in [*ours.named_parameters(), ("x", tx)]:
        ref = _t(np.asarray(dx)) if name == "x" else grads[name]
        err = float((p.grad - ref).abs().max())
        assert err <= GRAD_TOL * float(ref.abs().max()), (name, err)


def _model_inputs(rng, cfg, b=B, t=32):
    x_org = rng.rand(b, t, cfg.dim_freq).astype(np.float32)
    onehot = np.eye(cfg.dim_f0, dtype=np.float32)[
        rng.randint(0, cfg.dim_f0, (b, t))]
    x_f0 = np.concatenate([x_org, onehot], axis=-1)
    c_trg = np.eye(cfg.dim_spk_emb, dtype=np.float32)[:b]
    return x_f0, x_org, c_trg


def _assert_model_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    assert err <= MODEL_TOL * float(np.abs(want).max()), (what, err)


def test_generator_eval_forward_single_bf16(monkeypatch):
    """The generator's eval forward at bfloat16 compute on the single
    route in both packages (the mel decoder's 3 layers and content layer
    1, one ``lstm_sequence`` a direction; xp bfloat16 beside the default
    bfloat16 residuals): the mel within 2^-7 of JAX's."""
    rd = "bfloat16"
    _single_route(monkeypatch)
    cfg = SpeechSplitConfig(**TINY, residual_dtype=rd,
                            compute_dtype="bfloat16")
    jcfg = JaxConfig(**TINY, residual_dtype=rd, compute_dtype="bfloat16")
    inputs = _model_inputs(np.random.RandomState(21), cfg)
    jmodel = JaxSpeechSplit(jcfg, dtype=jnp.bfloat16)
    params = _jax_params(jmodel, *inputs)
    jax_calls = []
    real_jax = pallas_lstm.lstm_sequence

    def jax_single(*args):
        jax_calls.append(args[0].dtype)
        return real_jax(*args)

    monkeypatch.setattr(pallas_lstm, "lstm_sequence", jax_single)
    want = jmodel.apply({"params": params}, *inputs)
    calls = []
    real = lstm.lstm_sequence

    def single(xp, w, reverse=False, residual_dtype=F32):
        calls.append((xp.dtype, w.dtype))
        return real(xp, w, reverse, residual_dtype)

    monkeypatch.setattr(lstm, "lstm_sequence", single)
    model = _port(SpeechSplit, cfg, params, "speechsplit")
    with torch.no_grad():
        got = model(*map(torch.from_numpy, inputs))
    stream = _stream("bfloat16", rd)
    assert calls == [(_tdt(stream), BF16)] * 8
    assert jax_calls == [_jdt(stream)] * 8
    _assert_model_close(got, want, "mel")


def test_convert_batched_single_bf16(monkeypatch):
    """``convert_batched`` (2 pairs x 7 conditions) at bfloat16 compute and
    the default bfloat16 residuals, every BiLSTM layer on the single
    route in both packages: every converted mel within 2^-7 of JAX's."""
    _single_route(monkeypatch)
    # JAX's Pallas path at the F0 converter's batch of 2 too (its B >= 8
    # rule is the TPU's sublane tile; below it the scan path keeps xp
    # float32, which the kernels' stream dtype would not)
    monkeypatch.setattr(pallas_lstm, "supported", lambda batch, hidden: True)
    monkeypatch.setattr(jconvert, "_generate_jit",
                        jconvert._generate_jit.__wrapped__)
    jcfg = JaxConfig(**TINY, compute_dtype="bfloat16")
    cfg = SpeechSplitConfig(**TINY, compute_dtype="bfloat16")
    assert cfg.residual_dtype == "bfloat16"
    jg = JaxSpeechSplit(jcfg, dtype=jnp.bfloat16)
    jp = JaxF0Converter(jcfg, dtype=jnp.bfloat16)
    t = jcfg.max_len_pad
    g_params = _jax_params(jg, np.zeros((1, t, 337), np.float32),
                           np.zeros((1, t, 80), np.float32),
                           np.zeros((1, 82), np.float32))
    p_params = _jax_params(jp, np.zeros((1, t, 80), np.float32),
                           np.zeros((1, t, 257), np.float32))
    jax_pairs, port_pairs = _pairs([(30, 25), (20, 32)], seed=6)
    want = jconvert.convert_batched(jg, g_params, jp, p_params, jax_pairs)
    calls = []
    real = lstm.lstm_sequence

    def single(xp, w, reverse=False, residual_dtype=F32):
        calls.append(xp.shape[1])
        return real(xp, w, reverse, residual_dtype)

    monkeypatch.setattr(lstm, "lstm_sequence", single)
    g = _port(SpeechSplit, cfg, g_params, "speechsplit")
    p = _port(F0Converter, cfg, p_params, "f0_converter")
    got = tconvert.convert_batched(g, p, port_pairs)
    # the F0 decoder's 2 layers at batch 2, the generator's 4 at 7 x 2
    assert sorted(calls) == [2] * 4 + [14] * 8
    for got_pair, want_pair in zip(got, want):
        for (name, a), (_, w) in zip(got_pair, want_pair):
            _assert_model_close(a, w, name)


@pytest.mark.parametrize("name", ["speechsplit", "f0_converter"])
def test_train_step_single_matches_jax(monkeypatch, name):
    """One train step on the single route in both packages at bfloat16
    compute with the default config's bfloat16 residuals and Adam mu: 8
    (generator) or 4 (F0 converter) recorded ``lstm_sequence`` calls
    (bfloat16 xp and W_hh) with their gradient recurrences on bfloat16
    residuals, the loss within 1e-4 relative of JAX's, every gradient
    within 2% max-relative."""
    compute = "bfloat16"
    _single_route(monkeypatch)
    jcfg = JDEF.replace(compute_dtype=compute)
    cfg = DEF.replace(compute_dtype=compute)
    dtype = _jdt(compute)
    t = cfg.max_len_pad
    if name == "speechsplit":
        jmodel = JaxSpeechSplit(jcfg, dtype=dtype)
        params = _init(jmodel, np.zeros((1, t, cfg.dim_freq + cfg.dim_f0)),
                       np.zeros((1, t, cfg.dim_freq)),
                       np.zeros((1, cfg.dim_spk_emb)))
        make_jax, make_port, draws, n = (jax_train_step.make_train_step_fn,
                                         make_train_step, _draws(40, 4), 8)
    else:
        jmodel = JaxF0Converter(jcfg, dtype=dtype)
        params = _init(jmodel, np.zeros((1, t, cfg.dim_freq)),
                       np.zeros((1, t, cfg.dim_f0)))
        make_jax, make_port, draws, n = (jax_train_step.make_f0_train_step_fn,
                                         make_f0_train_step, _draws(41, 3), 4)
    batch = _batch8(8)
    _inject(monkeypatch, draws)
    want_loss, jgrads = _jax_step(monkeypatch, make_jax, jmodel, params,
                                  batch)
    jq, pq = _inject(monkeypatch, draws)
    calls, bwd = [], []
    real, real_bwd = lstm.lstm_sequence, lstm.lstm_direction_backward_reference

    def single(xp, w, reverse=False, residual_dtype=F32):
        calls.append((xp.dtype, w.dtype, residual_dtype, xp.requires_grad))
        return real(xp, w, reverse, residual_dtype)

    def single_bwd(*args, **kwargs):
        bwd.append(args[1].dtype)
        return real_bwd(*args, **kwargs)

    monkeypatch.setattr(lstm, "lstm_sequence", single)
    monkeypatch.setattr(lstm, "lstm_direction_backward_reference", single_bwd)
    state = create_train_state(cfg, 7, name, device="cpu")
    state.model.load_state_dict(jax_params_to_state_dict(params, name),
                                strict=True)
    state, loss = make_port(cfg)(state, batch)
    assert not pq
    w_dtype = _tdt(compute)
    assert calls == [(_tdt(_stream(compute, "bfloat16")), w_dtype, BF16,
                      True)] * n
    assert bwd == [BF16] * n  # the residuals the gradient reads
    err = abs(float(loss) - want_loss)
    assert err <= LOSS_RTOL * abs(want_loss), (float(loss), want_loss)
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jgrads), name)
    got = dict(state.model.named_parameters())
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        err = float((got[key].grad - ref).abs().max())
        assert err <= GRAD_TOL * float(ref.abs().max()), (key, err)
    assert not any(lstm.LAUNCHES.values())


def test_callers_run_on_the_single_route_bf16(monkeypatch, tmp_path):
    """The port's callers that reach the single route run on it at
    bfloat16 compute with the default residuals (the port alone, on the
    CPU): a ``cli.serve`` request over ``VoiceConverter`` (a short pair
    through ``convert_batched``, a long one through ``convert_long``, past
    ``max_len_pad`` frames), and two ``Solver`` steps; every recorded
    ``lstm_sequence`` call at bfloat16 W_hh and xp, the mels and losses
    finite."""
    import threading
    from http.server import HTTPServer

    from scipy.io import wavfile

    from speechsplit_tpu_torch.cli import serve
    from speechsplit_tpu_torch.pipeline import VoiceConverter
    from speechsplit_tpu_torch.training.solver import Solver
    from tests.test_torch_serve import FS, _post, _tone
    from tests.test_torch_solver import _run_config
    from tests.test_torch_training import CFG, _batch

    _single_route(monkeypatch)
    calls = []
    real = lstm.lstm_sequence

    def single(xp, w, reverse=False, residual_dtype=F32):
        calls.append((xp.dtype, w.dtype))
        return real(xp, w, reverse, residual_dtype)

    monkeypatch.setattr(lstm, "lstm_sequence", single)
    cfg = SpeechSplitConfig(**TINY, compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)
    converter = VoiceConverter(cfg, SpeechSplit(cfg, gen),
                               F0Converter(cfg, gen), device="cpu")
    lengths = {"short": FS // 5, "long": FS}  # 13 and 63 frames
    assert cfg.max_len_pad < 63
    for name, n in lengths.items():
        for side, f0 in (("src", 120.0), ("trg", 210.0)):
            wavfile.write(tmp_path / f"{name}_{side}.wav", FS,
                          (_tone(f0, n) * 32767).astype(np.int16))
    out = converter.convert_wav_files(str(tmp_path / "long_src.wav"),
                                      str(tmp_path / "long_trg.wav"),
                                      synthesize=False)
    assert all(np.isfinite(r["mel"]).all() for r in out.values())
    httpd = HTTPServer(("127.0.0.1", 0),
                       serve.build_handler(converter, str(tmp_path / "out")))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status, body = _post(f"http://127.0.0.1:{httpd.server_port}",
                             {"source_wav": str(tmp_path / "short_src.wav"),
                              "target_wav": str(tmp_path / "short_trg.wav")})
    finally:
        httpd.shutdown()
        thread.join()
    assert status == 200, body
    served = len(calls)
    assert served and set(calls) == {(BF16, BF16)}

    config = CFG.replace(compute_dtype="bfloat16", residual_dtype="bfloat16")
    solver = Solver(iter([_batch(0), _batch(1)]),
                    _run_config(tmp_path, num_iters=2), config, device="cpu")
    state = solver.train()  # raises on a non-finite loss
    # the generator's 4 merged layers, 2 directions, 2 steps
    assert calls[served:] == [(BF16, BF16)] * 16
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
