"""The port's single-direction LSTM op (``ops.lstm``, plain versions on
the CPU) against the JAX package's ``pallas_lstm.lstm_sequence`` kernels
run in interpret mode, its ``autograd.Function`` against ``jax.vjp``, the
port's ``LSTM(bidirectional=False)`` against JAX's and torch's, and the
route switch's batch limits against the kernel sources."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.models import layers as jl
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.interop import lstm_params_to_state_dict
from speechsplit_tpu_torch.models import layers as tl
from speechsplit_tpu_torch.ops import _build, bilstm, lstm
from tests.jax_interpret import interpret
from tests.test_torch_imports import _port_files

T = 12
B = 8  # pallas_lstm.supported() takes the Pallas path from B = 8
KERNEL_ATOL = 1e-5
LAYER_ATOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)
    monkeypatch.setattr(pallas_lstm, "RESIDUAL_DTYPE", jnp.float32)


def _inputs(h, seed, t=T, b=B):
    rng = np.random.RandomState(seed)
    xp = rng.randn(t, b, 4 * h).astype(np.float32)
    # JAX's w_hh is [H, 4H]; the port takes torch's [4H, H]
    w = (rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32)
    dh = rng.randn(t, b, h).astype(np.float32)
    return xp, w, dh


def _torch(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, atol=KERNEL_ATOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol)


@pytest.mark.parametrize("reverse", [False, True])
# the kernels' plan borders at 32 (31, 32, 33) and a wide width of one
# unit a block (64)
@pytest.mark.parametrize("h", [1, 8, 31, 32, 33, 64])
def test_plain_versions_match_pallas_interpret(h, reverse):
    """Lean forward against ``_infer``, residual-saving forward against
    ``_fwd`` (h, gates, c) and the gradient recurrence against
    ``_bwd_call`` on ``_fwd``'s residuals."""
    xp, w, dh = _inputs(h, 10 * h + reverse)
    want_h = pallas_lstm._infer(jnp.asarray(xp), jnp.asarray(w),
                                reverse=reverse)
    got_h = lstm.lstm_sequence(_torch(xp), _torch(w.T), reverse)
    _close(got_h, want_h)

    want = pallas_lstm._fwd(jnp.asarray(xp), jnp.asarray(w),
                            residual_dtype=jnp.float32, reverse=reverse)
    got = lstm.lstm_direction_forward_reference(_torch(xp), _torch(w.T),
                                                reverse)
    for g, r in zip(got, want):
        _close(g, r)

    want_dx = pallas_lstm._bwd_call(jnp.asarray(dh), want[1], want[2],
                                    jnp.asarray(w), reverse=reverse)
    got_dx = lstm.lstm_direction_backward_reference(
        _torch(dh), _torch(np.asarray(want[1])), _torch(np.asarray(want[2])),
        _torch(w.T), reverse)
    _close(got_dx, want_dx)
    assert not any(lstm.LAUNCHES.values())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h", [8, 32])
def test_function_grads_match_jax_vjp(h, reverse):
    xp, w, dh = _inputs(h, 100 + 10 * h + reverse)

    def jax_op(x, wh):
        return pallas_lstm.lstm_sequence(x, wh, jnp.float32, reverse)

    want_h, vjp = jax.vjp(jax_op, jnp.asarray(xp), jnp.asarray(w))
    want_dxp, want_dw = vjp(jnp.asarray(dh))

    xp_t = _torch(xp).requires_grad_(True)
    w_t = _torch(w.T.copy()).requires_grad_(True)
    got_h = lstm.lstm_sequence(xp_t, w_t, reverse, torch.float32)
    assert type(got_h.grad_fn).__name__ == "LSTMFunctionBackward"
    got_dxp, got_dw = torch.autograd.grad(got_h, (xp_t, w_t), _torch(dh))
    _close(got_h, want_h)
    _close(got_dxp, want_dxp)
    _close(got_dw.T, want_dw)
    assert not any(lstm.LAUNCHES.values())


def test_cpu_dispatch_takes_the_plain_version():
    xp, w, _ = _inputs(8, 3)
    with torch.no_grad():
        got = lstm.lstm_sequence(_torch(xp), _torch(w.T), True)
    assert got.grad_fn is None
    want = lstm.lstm_sequence_reference(_torch(xp), _torch(w.T), True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not any(lstm.LAUNCHES.values())


def test_reverse_direction_runs_backwards_in_time():
    """h at the last time index of a reverse direction sees only xp[T-1]."""
    xp, w, _ = _inputs(8, 4)
    h = lstm.lstm_sequence(_torch(xp), _torch(w.T), True)
    h_last = lstm.lstm_sequence(_torch(xp[-1:]), _torch(w.T), True)
    torch.testing.assert_close(h[-1], h_last[0])


def _uni_pair(in_features, hidden, layers, seed):
    x = np.random.RandomState(seed).randn(B, T, in_features).astype(
        np.float32)
    mod = jl.LSTM(hidden, num_layers=layers, bidirectional=False)
    params = mod.init(jax.random.PRNGKey(seed), x)["params"]
    ours = tl.LSTM(in_features, hidden, layers, torch.Generator(),
                   bidirectional=False, residual_dtype=torch.float32)
    ours.load_state_dict(lstm_params_to_state_dict(params), strict=True)
    return x, mod, params, ours


@pytest.mark.parametrize("layers", [1, 2])
def test_unidirectional_lstm_matches_jax_and_torch(layers):
    x, mod, params, ours = _uni_pair(12, 16, layers, layers)
    want = mod.apply({"params": params}, x)
    with torch.no_grad():
        got = ours(_torch(x))
    _close(got, want, atol=LAYER_ATOL)
    # torch.nn.LSTM declares the same parameters under the same names
    ref = torch.nn.LSTM(12, 16, layers, batch_first=True)
    ref.load_state_dict(ours.state_dict(), strict=True)
    with torch.no_grad():
        torch.testing.assert_close(got, ref(_torch(x))[0], rtol=0,
                                   atol=LAYER_ATOL)
    assert not any(lstm.LAUNCHES.values())


def test_unidirectional_lstm_declares_torch_names_only():
    ours = tl.LSTM(5, 4, 2, torch.Generator(), bidirectional=False)
    ref = torch.nn.LSTM(5, 4, 2)
    assert {k: tuple(v.shape) for k, v in ours.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref.state_dict().items()}
    with pytest.raises(ValueError, match="BiLSTM"):
        ours(torch.zeros(2, 3, 5), mode="streams")


def test_unidirectional_lstm_grads_match_torch():
    """Autograd through the port's layer (LSTMFunction, then dW_hh as one
    matmul) against torch.nn.LSTM's own backward."""
    x, _, _, ours = _uni_pair(6, 8, 2, 5)
    ref = torch.nn.LSTM(6, 8, 2, batch_first=True)
    ref.load_state_dict(ours.state_dict(), strict=True)
    xt = _torch(x).requires_grad_(True)
    xr = _torch(x).requires_grad_(True)
    ours(xt).square().sum().backward()
    ref(xr)[0].square().sum().backward()
    torch.testing.assert_close(xt.grad, xr.grad, rtol=0, atol=1e-5)
    theirs = dict(ref.named_parameters())
    for name, p in ours.named_parameters():
        torch.testing.assert_close(p.grad, theirs[name].grad, rtol=0,
                                   atol=1e-5)


def test_bidirectional_route_follows_merged_bidir_fits(monkeypatch):
    """A BiLSTM layer asks merged_bidir_fits with ``grad`` set as the
    layer will record, and where it is false runs one ``lstm_sequence``
    per direction with the same result as the merged route."""
    ours = tl.LSTM(6, 8, 2, torch.Generator().manual_seed(1),
                   residual_dtype=torch.float32)
    x = torch.from_numpy(np.random.RandomState(6).randn(3, 9, 6).astype(
        np.float32))
    asked = []
    calls = []
    real_fits, real_seq = bilstm.merged_bidir_fits, lstm.lstm_sequence

    def fits(t, b, h, grad=False):
        asked.append((t, b, h, grad))
        return False

    def seq(xp, w, reverse=False, residual_dtype=torch.float32):
        calls.append(reverse)
        return real_seq(xp, w, reverse, residual_dtype)

    with torch.no_grad():
        want = ours(x)
    monkeypatch.setattr(bilstm, "merged_bidir_fits", fits)
    monkeypatch.setattr(lstm, "lstm_sequence", seq)
    with torch.no_grad():
        got = ours(x)
    ours(x)
    assert asked == [(9, 3, 8, False), (9, 3, 8, True)]
    assert calls == [False, True] * 4
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert real_fits(9, 3, 8)


def _budget_floats(stem):
    """The ``kSmemBudget`` of a kernel source, in floats."""
    text = (_build.CSRC / f"{stem}.cu").read_text()
    a, b = re.search(r"kSmemBudget = (\d+) \* (\d+);", text).groups()
    return int(a) * int(b) // 4


@pytest.mark.parametrize("h,infer,grad", [(512, 4984, 4842),
                                          (256, 10104, 4970),
                                          (8, 5110, 5094)])
def test_merged_bidir_fits_at_the_kernel_limits(h, infer, grad):
    """The merged kernels' launch plans (csrc/bilstm_infer.cu: cell state
    [units][B], units = 8, or 4 from H=9 to kSplitMaxH, beside a row of
    two buffers of H + 4 units floats, and for the residual-saving
    forward h and c a unit; csrc/bilstm_bwd.cu: dc carry [units][B]
    beside a row of 4H + kVals units: the warps' 8 partial sums and two
    buffers of 7 residuals) on the budgets their sources state."""
    units = 4 if 8 < h <= 256 else min(h, 8)
    assert _build.source_constant("bilstm_infer", "kSplitMaxH") == 256
    vals = _build.source_constant("bilstm_bwd", "kVals")
    assert vals == 8 + 2 * 7
    row = 2 * (h + 4 * units)
    assert infer == (_budget_floats("bilstm_infer") - row) // units
    fwd = (_budget_floats("bilstm_infer") - row - 2 * units) // units
    bwd_units = min(h, 8)
    bwd = (_budget_floats("bilstm_bwd") - 4 * h - vals * bwd_units) // (
        bwd_units)
    assert grad == min(fwd, bwd) == bwd
    assert bilstm.merged_max_batch(h) == infer
    assert bilstm.merged_max_batch(h, grad=True) == grad
    assert bilstm.merged_bidir_fits(192, infer, h)
    assert not bilstm.merged_bidir_fits(192, infer + 1, h)
    assert bilstm.merged_bidir_fits(192, grad, h, grad=True)
    assert not bilstm.merged_bidir_fits(192, grad + 1, h, grad=True)
    assert not bilstm.merged_bidir_fits(192, 8, 513)


@pytest.mark.parametrize("stem,row_floats,limit", [
    # two buffers of h_{t-1} [H] and of the units' gate inputs [4][4],
    # and the row's h and c [2][4]
    ("lstm_infer", 2 * (512 + 4 * 4) + 2 * 4, lstm.MAX_FWD_BATCH),
    # d_pre [4H] and, per unit, the 8 warps' partial sums and two
    # buffers of the 7 residuals
    ("lstm_bwd", 4 * 512 + (8 + 2 * 7) * 4, lstm.MAX_BWD_BATCH)])
def test_single_direction_limits_hold_twice_the_merged(stem, row_floats,
                                                       limit):
    """The training kernels' limits: ``lstm_fwd`` (in
    ``csrc/lstm_infer.cu``) and ``lstm_bwd``, their wide plans (the
    narrow ones keep no state in shared memory). At H=512 their plan
    gives 4 units a block; the limit is the largest batch whose cell
    state (dc carry) [4][B] fits beside one row of the staged values in
    the source's budget, at least twice the merged lean kernel's, and no
    lower than the 13,948 rows ``lstm_fwd`` took before its wide plan."""
    what = {"lstm_infer": "lstm_fwd", "lstm_bwd": "lstm_bwd"}[stem]
    budget = _budget_floats(stem)
    assert 4 * limit + row_floats <= budget < 4 * (limit + 1) + row_floats
    assert limit >= 2 * bilstm.merged_max_batch(512)
    assert limit >= 13_948
    xp = torch.zeros(1, limit + 1, 4)
    with pytest.raises(ValueError, match=f"B <= {limit}"):
        lstm._check(xp, torch.zeros(4, 1), what, limit)
    lstm._check(xp[:, :limit].contiguous(), torch.zeros(4, 1), what, limit)
    # the same limit at every dtype set the wrappers pass: bfloat16
    # W_hh, bfloat16 residuals beside it and a bfloat16 xp stream
    bf16 = torch.bfloat16
    for rd, stream in ((torch.float32, torch.float32), (bf16, bf16)):
        with pytest.raises(ValueError, match=f"B <= {limit}"):
            lstm._check(xp.to(stream), torch.zeros(4, 1, dtype=bf16), what,
                        limit, rd)
        lstm._check(xp[:, :limit].to(stream).contiguous(),
                    torch.zeros(4, 1, dtype=bf16), what, limit, rd)


def test_lean_wrapper_takes_batches_past_the_training_limit(monkeypatch):
    """``lstm_infer`` has no batch limit (its wide plan tiles the batch
    over the grid, its narrow plan gives each row its own lanes): the
    wrapper passes 15,000 rows to the launch, the plan left to the source
    (0), float32 W_hh and xp (dtype codes 0, 0), with a [B, H] cell-state
    scratch; ``lstm_fwd`` refuses them."""
    calls = []

    class Library:
        lstm_error_string = None

        def lstm_infer_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(lstm, "_library", Library)
    monkeypatch.setattr(lstm, "_stream", lambda x: 0)
    monkeypatch.setitem(lstm.LAUNCHES, "lstm_infer", 0)
    batch = 15_000
    assert batch > lstm.MAX_FWD_BATCH
    xp, w = torch.zeros(2, batch, 32), torch.zeros(32, 8)
    h = lstm.lstm_infer_cuda(xp, w, True)
    assert tuple(h.shape) == (2, batch, 8)
    (args,) = calls
    # T, B, H, reverse, plan, W_hh and xp bfloat16, device, stream
    assert args[4:] == (2, batch, 8, 1, 0, 0, 0, 0, 0)
    assert len({args[2], args[3]}) == 2  # h and the scratch
    assert lstm.LAUNCHES["lstm_infer"] == 1
    with pytest.raises(ValueError, match=f"B <= {lstm.MAX_FWD_BATCH}"):
        lstm.lstm_forward_cuda(xp, w, False)
    assert lstm.LAUNCHES["lstm_fwd"] == 0


def test_gradient_wrapper_passes_a_zeroed_barrier_word(monkeypatch):
    """``lstm_bwd``'s wide plan meets at a split grid barrier on a word
    the wrapper zeroes for each launch: the launch gets dh, g, c, w, dx
    and that word, the bfloat16 residuals' float32 carry (none here),
    then T, B, H, reverse, the residuals' and W_hh's bfloat16 codes, the
    device and the stream."""
    calls, words = [], []

    class Library:
        lstm_bwd_error_string = None

        def lstm_bwd_launch(self, *args):
            calls.append(args)
            return 0

    def barrier_word(x):
        words.append(torch.zeros(1, dtype=torch.int32))
        return words[-1]

    monkeypatch.setattr(lstm, "_bwd_library", Library)
    monkeypatch.setattr(lstm, "_barrier_word", barrier_word)
    monkeypatch.setattr(lstm, "_stream", lambda x: 0)
    monkeypatch.setitem(lstm.LAUNCHES, "lstm_bwd", 0)
    dh, c = torch.zeros(3, 5, 40), torch.ones(3, 5, 40)
    g, w = torch.zeros(3, 5, 160), torch.zeros(160, 40)
    dx = lstm.lstm_backward_cuda(dh, g, c, w, True)
    (args,) = calls
    assert args[:6] == (dh.data_ptr(), g.data_ptr(), c.data_ptr(),
                        w.data_ptr(), dx.data_ptr(), words[0].data_ptr())
    assert args[6:] == (None, 3, 5, 40, 1, 0, 0, 0, 0)
    assert int(words[0]) == 0
    assert lstm.LAUNCHES["lstm_bwd"] == 1


def test_forward_wrapper_passes_a_zeroed_barrier_word(monkeypatch):
    """``lstm_fwd``'s wide plan meets at a split grid barrier on a word
    the wrapper zeroes for each launch: the launch gets xp, w, h, g, c and
    that word, then T, B, H, reverse, the residuals', W_hh's and xp's
    bfloat16 codes, the device and the stream."""
    calls, words = [], []

    class Library:
        lstm_error_string = None

        def lstm_fwd_launch(self, *args):
            calls.append(args)
            return 0

    def barrier_word(x):
        words.append(torch.zeros(1, dtype=torch.int32))
        return words[-1]

    monkeypatch.setattr(lstm, "_library", Library)
    monkeypatch.setattr(lstm, "_barrier_word", barrier_word)
    monkeypatch.setattr(lstm, "_stream", lambda x: 0)
    monkeypatch.setitem(lstm.LAUNCHES, "lstm_fwd", 0)
    xp, w = torch.zeros(3, 5, 160), torch.zeros(160, 40)
    h, g, c = lstm.lstm_forward_cuda(xp, w, True)
    assert (h.shape, g.shape, c.shape) == ((3, 5, 40), (3, 5, 160),
                                           (3, 5, 40))
    (args,) = calls
    assert args[:6] == (xp.data_ptr(), w.data_ptr(), h.data_ptr(),
                        g.data_ptr(), c.data_ptr(), words[0].data_ptr())
    assert args[6:] == (3, 5, 40, 1, 0, 0, 0, 0, 0)
    assert int(words[0]) == 0
    assert lstm.LAUNCHES["lstm_fwd"] == 1


@pytest.mark.parametrize("plan,code", [("auto", 0), ("narrow", 1),
                                       ("wide", 2)])
def test_forced_plan_reaches_the_launch(monkeypatch, plan, code):
    """Only the measuring entry forces a plan; it counts as a launch of
    ``lstm_infer`` like the public wrapper, which always leaves the plan
    to the source."""
    calls = []

    class Library:
        lstm_error_string = None

        def lstm_infer_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(lstm, "_library", Library)
    monkeypatch.setattr(lstm, "_stream", lambda x: 0)
    monkeypatch.setitem(lstm.LAUNCHES, "lstm_infer", 0)
    xp, w = torch.zeros(3, 5, 32), torch.zeros(32, 8)
    lstm._lstm_infer_plan(xp, w, False, plan)
    lstm.lstm_infer_cuda(xp, w, False)
    assert [args[8] for args in calls] == [code, 0]
    assert lstm.LAUNCHES["lstm_infer"] == 2


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_version_past_the_old_limit_matches_pallas(reverse):
    """The lean forward's plain version at a batch no single-direction
    kernel took before (T=2, B=14,000, H=8) against ``_infer`` in
    interpret mode."""
    xp, w, _ = _inputs(8, 40 + reverse, t=2, b=14_000)
    want = pallas_lstm._infer(jnp.asarray(xp), jnp.asarray(w),
                              reverse=reverse)
    got = lstm.lstm_sequence(_torch(xp), _torch(w.T), reverse)
    _close(got, want)


def test_plan_border_is_stated_by_the_source():
    """The lean kernel's border between its narrow plan (rows on lanes,
    one launch) and its wide plan (a tiled step product): a constant of
    ``csrc/lstm_infer.cu`` that Python reads, between content layer 1's H=8
    and the mel decoder's H=512, so the main path runs both plans."""
    border = _build.source_constant("lstm_infer", "kNarrowMaxH")
    assert border == lstm.NARROW_MAX_H
    assert 8 <= border < 512


def test_wrapper_checks():
    xp = torch.zeros(4, 2, 32)
    with pytest.raises(ValueError, match=r"\[4H, H\]"):
        lstm._check(xp, torch.zeros(8, 32), "lstm_infer", None)
    with pytest.raises(ValueError, match="H <="):
        lstm._check(torch.zeros(1, 1, 4 * 513), torch.zeros(4 * 513, 513),
                    "lstm_infer", None)
    # the dtype sets JAX's single route forms pass; no other does
    bf16, w = torch.bfloat16, torch.zeros(32, 8)
    lstm._check(xp.bfloat16(), w.bfloat16(), "lstm_infer", None)
    lstm._check(xp, w.bfloat16(), "lstm_infer", None)
    lstm._check(xp, w, "lstm_fwd", None, bf16)
    lstm._check(xp, w.bfloat16(), "lstm_fwd", None, torch.float32)
    lstm._check(xp.bfloat16(), w.bfloat16(), "lstm_fwd", None, bf16)
    for x, wd, rd in ((xp.bfloat16(), w, None), (xp.half(), w, None),
                      (xp, w.half(), None), (xp, w.bfloat16(), bf16),
                      (xp.bfloat16(), w.bfloat16(), torch.float32),
                      (xp.bfloat16(), w, bf16)):
        with pytest.raises(ValueError, match="nowhere"):
            lstm._check(x, wd, "lstm_infer", None, rd)
    g = torch.zeros(4, 2, 32)
    with pytest.raises(ValueError, match="dh"):
        lstm._check_residuals(torch.zeros(4, 2, 7), g, torch.zeros(4, 2, 8))
    lstm._check_residuals(torch.zeros(4, 2, 8, dtype=bf16), g.bfloat16(),
                          torch.zeros(4, 2, 8, dtype=bf16))
    with pytest.raises(ValueError, match="one residual dtype"):
        lstm._check_residuals(torch.zeros(4, 2, 8, dtype=bf16), g,
                              torch.zeros(4, 2, 8))
    with pytest.raises(ValueError, match="residual_dtype"):
        lstm._check_residuals(torch.zeros(4, 2, 8).half(), g.half(),
                              torch.zeros(4, 2, 8).half())


def test_import_scan_covers_the_new_op():
    assert "lstm.py" in {p.name for p in _port_files()}
