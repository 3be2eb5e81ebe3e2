"""Every float32/bfloat16 set JAX's recurrence ops take, through the
port's ops (plain versions and autograd Functions on the CPU) against
the JAX package's ops in interpret mode: forward and ``jax.vjp`` on the
same inputs and cotangents.

The sets: a bfloat16 xp beside a float32 W_hh at residuals None (the
bfloat16 default), float32 and bfloat16; a float32 xp beside a bfloat16
W_hh and bfloat16 residuals; a bfloat16 xp beside a bfloat16 W_hh and
float32 residuals; each in the merged op (``bilstm_sequence``) and the
single-direction op (``lstm_sequence``). A bfloat16 xp into the
multi-stream op on both of the port's plans. Fused calls whose x, W_ih
and W_hh differ in dtype.

Bars, those of tests/test_torch_compute_bf16.py (its module docstring),
applied by ``_close``:
- float32 outputs: 1e-5, absolute or relative to the largest magnitude
  where that is above 1;
- bfloat16 outputs: one bfloat16 ulp of the element plus float32 noise
  of 1e-6 of the largest magnitude (two ulps for the dxp of a whole
  Function, whose own g and c may round apart);
- dW_hh and dW_ih at bfloat16 residuals: 2^-8 of the largest magnitude
  plus one ulp of the element;
- beside a bfloat16 W_hh at most 2% of an output may miss those bars,
  within 2^-8 of its largest magnitude (the flips of bfloat16 compute);
  beside a float32 one none may.
The multi-stream op hands back its xp cotangent in float32 in JAX and in
bfloat16 in the port (autograd casts a gradient to its input's dtype):
JAX's is rounded to bfloat16 before the comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pallas_lstm, pallas_multilstm
from speechsplit_tpu_torch.ops import bilstm, lstm, multi_bilstm
from tests.jax_interpret import interpret
from tests.test_torch_compute_bf16 import (
    FLIP,
    FLIP_SHARE,
    assert_dw_close,
)
from tests.test_torch_residual_bf16 import H_TOL, NOISE, _f32, _t, bf16_ulp

T = 6
B = 4
H = 8
BF16 = torch.bfloat16
F32 = torch.float32
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, None: None}
_T = {"float32": F32, "bfloat16": BF16, None: None}

# (xp, W_hh, residuals): the sets JAX's ops take beyond those its models
# form
PAIRS = pytest.mark.parametrize("xp,w,rd", [
    ("bfloat16", "float32", None),
    ("bfloat16", "float32", "float32"),
    ("bfloat16", "float32", "bfloat16"),
    ("float32", "bfloat16", "bfloat16"),
    ("bfloat16", "bfloat16", "float32"),
])


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def _close(got, want, what: str, w_bf16: bool, ulps: int = 1) -> None:
    """``got`` (torch) against ``want`` (JAX) at the module's bars."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, what
    top = float(np.abs(w).max())
    if got.dtype == BF16:
        near = ulps * bf16_ulp(np.maximum(np.abs(g), np.abs(w))) + (
            NOISE * top)
    else:
        near = H_TOL * max(top, 1.0)
    err = np.abs(g - w)
    share = float((err > near).mean())
    assert share <= (FLIP_SHARE if w_bf16 else 0.0), (what, share,
                                                        float(err.max()))
    assert float(err.max()) <= FLIP * top, (what, float(err.max()), top)


def _dw_close(got, want, what: str, rd, w_bf16: bool) -> None:
    if rd == "float32" and not w_bf16:
        _close(got, want, what, False)
    else:
        assert_dw_close(got, want, what)


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages: a JAX array of ``dtype`` and the
    torch tensor of its bits."""
    j = jnp.asarray(a).astype(_J[dtype])
    return j, _t(_f32(j)).to(_T[dtype])


def _weights(rng, h, n, dtype):
    """n JAX-layout [h, 4h] W_hh and their torch [4h, h] transposes."""
    out = [_pair((rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32),
                 dtype) for _ in range(n)]
    return [j for j, _ in out], [t.t().contiguous() for _, t in out]


def _grads(port_op, jax_op, jins, tins, dh):
    """(JAX's outputs, JAX's input cotangents, the port's outputs, the
    port's input cotangents) for cotangents ``dh`` (numpy)."""
    outs, vjp = jax.vjp(jax_op, *jins)
    want = vjp(tuple(jnp.asarray(d).astype(o.dtype)
                     for d, o in zip(dh, outs)))
    leaves = [t.clone().requires_grad_(True) for t in tins]
    got_h = port_op(*leaves)
    got = torch.autograd.grad(got_h, leaves,
                              [_t(d).to(g.dtype) for d, g in zip(dh, got_h)])
    return outs, want, got_h, got


@PAIRS
def test_merged_op_pairs_match_jax(xp, w, rd):
    rng = np.random.RandomState(11)
    jx, tx = zip(*[_pair(rng.randn(T, B, 4 * H).astype(np.float32), xp)
                   for _ in "fb"])
    jw, tw = _weights(rng, H, 2, w)
    dh = [rng.randn(T, B, H).astype(np.float32) for _ in "fb"]
    w_bf16 = w == "bfloat16"

    # the lean forward
    lean_want = pallas_lstm.bilstm_sequence(*jx, *jw, _J[rd])
    with torch.no_grad():
        lean = bilstm.bilstm_sequence(*tx, *tw, _T[rd])
    for g, r in zip(lean, lean_want):
        assert g.dtype == F32 and r.dtype == jnp.float32
        _close(g, r, "lean h", w_bf16)

    outs, want, got_h, got = _grads(
        lambda *a: bilstm.bilstm_sequence(*a, _T[rd]),
        lambda *a: pallas_lstm.bilstm_sequence(*a, _J[rd]),
        [*jx, *jw], [*tx, *tw], dh)
    assert type(got_h[0].grad_fn).__name__ == "BiLSTMFunctionBackward"
    for g, r in zip(got_h, outs):
        _close(g, r, "h", w_bf16)
    for k, (g, r) in enumerate(zip(got, want)):
        assert g.dtype == _T[xp if k < 2 else w], k
        if k < 2:
            _close(g, r, f"dxp {k}", w_bf16, ulps=2)
        else:
            _dw_close(g, _f32(r).T, f"dw {k}", rd, w_bf16)
    assert not any(bilstm.LAUNCHES.values())


@PAIRS
def test_single_op_pairs_match_jax(xp, w, rd):
    rng = np.random.RandomState(12)
    jx, tx = _pair(rng.randn(T, B, 4 * H).astype(np.float32), xp)
    jw, tw = _weights(rng, H, 1, w)
    dh = [rng.randn(T, B, H).astype(np.float32)]
    w_bf16 = w == "bfloat16"
    reverse = rd == "float32"  # both walks over the pairs

    lean_want = pallas_lstm.lstm_sequence(jx, jw[0], _J[rd], reverse)
    with torch.no_grad():
        lean = lstm.lstm_sequence(tx, tw[0], reverse, _T[rd])
    _close(lean, lean_want, "lean h", w_bf16)

    outs, want, got_h, got = _grads(
        lambda a, b: (lstm.lstm_sequence(a, b, reverse, _T[rd]),),
        lambda a, b: (pallas_lstm.lstm_sequence(a, b, _J[rd], reverse),),
        [jx, *jw], [tx, *tw], dh)
    assert type(got_h[0].grad_fn).__name__ == "LSTMFunctionBackward"
    _close(got_h[0], outs[0], "h", w_bf16)
    assert got[0].dtype == _T[xp] and got[1].dtype == _T[w]
    _close(got[0], want[0], "dxp", w_bf16, ulps=2)
    _dw_close(got[1], _f32(want[1]).T, "dw", rd, w_bf16)
    assert not any(lstm.LAUNCHES.values())


# (4H, H) a stream: the generator's encoder widths (the port's lane
# plan), and a direction past its 32 (the port's block plan)
MULTI = pytest.mark.parametrize("streams", [
    [(32, 8), (128, 32), (4, 1)], [(32, 8), (160, 40)]])


@MULTI
def test_multi_op_takes_bfloat16_xp_as_jax(streams):
    """A bfloat16 xp into the multi-stream op, residuals None: h and dW_hh
    against JAX's, and the xp cotangent against JAX's float32 one rounded
    to bfloat16 (the port's comes back in xp's dtype)."""
    rng = np.random.RandomState(13)
    n = len(streams)
    jx, tx, jw, tw = [], [], [], []
    for four_h, h in streams:
        for _ in "fb":
            a, b = _pair(rng.randn(T, B, four_h).astype(np.float32),
                         "bfloat16")
            jx.append(a)
            tx.append(b)
        w_j, w_t = _weights(rng, h, 2, "float32")
        jw += w_j
        tw += w_t
    dh = [rng.randn(T, B, h).astype(np.float32)
          for _, h in streams for _ in "fb"]
    outs, want, got_h, got = _grads(
        lambda *a: multi_bilstm.multi_bilstm_sequence(n, *a),
        lambda *a: pallas_multilstm.multi_bilstm_sequence(n, None, *a),
        [*jx, *jw], [*tx, *tw], dh)
    assert type(got_h[0].grad_fn).__name__ == "MultiBiLSTMFunctionBackward"
    for g, r in zip(got_h, outs):
        _close(g, r, "h", False)
    d2 = 2 * n
    for k, (g, r) in enumerate(zip(got, want)):
        if k < d2:
            assert r.dtype == jnp.float32 and g.dtype == BF16
            _close(g, jnp.asarray(r).astype(jnp.bfloat16), f"dxp {k}", False)
        else:
            assert_dw_close(g, _f32(r).T, f"dw {k}")
    with torch.no_grad():
        lean = multi_bilstm.multi_bilstm_sequence(n, *tx, *tw)
    for g, r in zip(lean, pallas_multilstm.multi_bilstm_sequence(
            n, None, *jx, *jw)):
        _close(g, r, "lean h", False)
    assert not any(multi_bilstm.LAUNCHES.values())


# (x, W_ih, W_hh): the fused op's mixes (x streams in W_ih's dtype)
MIXES = pytest.mark.parametrize("x,wi,w", [
    ("bfloat16", "float32", "float32"),
    ("float32", "bfloat16", "bfloat16"),
    ("float32", "float32", "bfloat16"),
    ("bfloat16", "bfloat16", "float32"),
])


@MIXES
def test_fused_op_mixes_match_jax(x, wi, w):
    """x, W_ih and W_hh of mixed dtypes, residuals None: h and every
    gradient against JAX's ``bilstm_sequence_fused``."""
    rng = np.random.RandomState(14)
    i_dim = 5
    jx, tx = _pair(rng.randn(T, B, i_dim).astype(np.float32), x)
    jwi, twi = zip(*[_pair((rng.randn(i_dim, 4 * H) / 3).astype(np.float32),
                           wi) for _ in "fb"])
    twi = [t.t().contiguous() for t in twi]
    jb, tb = zip(*[_pair(rng.randn(4 * H).astype(np.float32), "float32")
                   for _ in "fb"])
    jw, tw = _weights(rng, H, 2, w)
    dh = [rng.randn(T, B, H).astype(np.float32) for _ in "fb"]
    w_bf16 = "bfloat16" in (wi, w)
    outs, want, got_h, got = _grads(
        bilstm.bilstm_sequence_fused, pallas_lstm.bilstm_sequence_fused,
        [jx, *jwi, *jb, *jw], [tx, *twi, *tb, *tw], dh)
    assert type(got_h[0].grad_fn).__name__ == "BiLSTMFusedFunctionBackward"
    for g, r in zip(got_h, outs):
        _close(g, r, "h", w_bf16)
    names = ("dx", "dwi_f", "dwi_b", "db_f", "db_b", "dw_f", "dw_b")
    for name, g, r in zip(names, got, want):
        r = _f32(r).T if name.startswith("dw") else r
        if name.startswith("dw"):
            assert_dw_close(g, r, name)
        else:
            _close(g, r, name, w_bf16, ulps=2)
    with torch.no_grad():
        lean = bilstm.bilstm_sequence_fused(tx, *twi, *tb, *tw)
    for g, r in zip(lean, pallas_lstm.bilstm_sequence_fused(
            jx, *jwi, *jb, *jw)):
        _close(g, r, "lean h", w_bf16)
    assert not any(bilstm.LAUNCHES.values())


def _guard(monkeypatch, module, name, check, depth):
    """``module.name`` (a plain version the ops run on the CPU where CUDA
    launches its kernel) made to hold its arguments to ``check`` first,
    the dtype rule of that kernel's wrapper, where an op calls it (not
    where another plain version does, ``depth``); returns its calls."""
    real, seen = getattr(module, name), []

    def guarded(*args, **kwargs):
        if not depth:
            check(*args, **kwargs)
            seen.append(name)
        depth.append(name)
        try:
            return real(*args, **kwargs)
        finally:
            depth.pop()

    monkeypatch.setattr(module, name, guarded)
    return seen


@pytest.mark.parametrize("switch", [
    None, "GRAD_STREAM_FOLLOWS_RESIDUAL", "DH_STREAM_FOLLOWS_RESIDUAL",
    "XP_STREAM_FOLLOWS_COMPUTE", "H_STREAM_FOLLOWS_COMPUTE"])
def test_ops_hand_the_kernels_only_the_sets_they_take(monkeypatch, switch):
    """Every set of every op, lean and with its gradient, under each
    stream switch flipped from its default: each call the ops make of a
    kernel's plain version (the CUDA path makes the same call of the
    kernel's wrapper) is of a set that wrapper takes (the forwards' sets,
    the gradients' ``_check_residuals``, the fused kernels' one dtype, the
    multi-stream kernels' float32 xp), and each op's outputs come back in
    the dtypes the switches give."""
    if switch is not None:
        monkeypatch.setattr(bilstm, switch,
                            not getattr(bilstm, switch))
    seen, depth = [], []

    def takes(xp, w, rd):
        # the forward kernels' instances: xp float32 beside a float32
        # W_hh; beside a bfloat16 one either xp, in the residuals' dtype
        # where they are saved
        ok = xp == F32 if w == F32 else rd is None or xp == rd
        assert ok, (xp, w, rd)

    def merged(xp_f, xp_b, w_f, w_b, rd=None):
        takes(xp_f.dtype, w_f.dtype, rd)

    def single(xp, w, reverse, rd=None):
        takes(xp.dtype, w.dtype, rd)

    def fused(x, wi_f, wi_b, b_f, b_b, w_f, w_b, rd=None):
        bilstm._check_fused(x, wi_f, wi_b, b_f, b_b, w_f, w_b)

    def multi(n, *args, residual_dtype=None):
        multi_bilstm._check(n, args[:2 * n], args[2 * n:4 * n])

    for module, name, check in (
            (bilstm, "bilstm_sequence_reference", merged),
            (bilstm, "bilstm_forward_reference", merged),
            (bilstm, "bilstm_backward_reference",
             lambda *a: bilstm._check_residuals(*a[:7])),
            (bilstm, "bilstm_sequence_fused_reference", fused),
            (bilstm, "bilstm_fused_forward_reference", fused),
            (lstm, "lstm_sequence_reference", single),
            (lstm, "lstm_direction_forward_reference", single),
            (lstm, "lstm_direction_backward_reference",
             lambda dh, g, c, w, reverse: lstm._check_residuals(dh, g, c)),
            (multi_bilstm, "multi_bilstm_sequence_reference", multi),
            (multi_bilstm, "multi_bilstm_forward_reference", multi)):
        seen += [_guard(monkeypatch, module, name, check, depth)]

    def run(op, inputs):
        with torch.no_grad():
            lean = op(*inputs)
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        outs = op(*leaves)
        torch.autograd.grad([o.float().sum() for o in outs], leaves)
        return lean, outs

    g = torch.Generator().manual_seed(15)
    rand = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    sets = [(xp, w, rd) for xp in (F32, BF16) for w in (F32, BF16)
            for rd in (None, F32, BF16)]
    for xp, w, rd in sets:
        h_dtype = bilstm._h_stream_dtype(w, rd)
        xps = [rand(3, 2, 16).to(xp) for _ in "fb"]
        ws = [rand(16, 4).to(w) for _ in "fb"]
        for outs in run(lambda *a: bilstm.bilstm_sequence(*a, rd),
                        [*xps, *ws]):
            assert {o.dtype for o in outs} == {h_dtype}
        for outs in run(lambda a, b: (lstm.lstm_sequence(a, b, True, rd),),
                        [xps[0], ws[0]]):
            assert outs[0].dtype == h_dtype
        wis = [rand(16, 5).to(xp) for _ in "fb"]
        bs = [rand(16) for _ in "fb"]
        for outs in run(lambda *a: bilstm.bilstm_sequence_fused(*a, rd),
                        [rand(3, 2, 5).to(w), *wis, *bs, *ws]):
            assert {o.dtype for o in outs} == {h_dtype}
        for outs in run(lambda *a: bilstm.bilstm_layer(*a, rd),
                        [rand(3, 2, 5).to(w), *wis, *bs, *ws]):
            assert {o.dtype for o in outs} == {h_dtype}
        for outs in run(lambda *a: multi_bilstm.multi_bilstm_sequence(
                1, *a, residual_dtype=rd), [*xps, *ws]):
            assert {o.dtype for o in outs} == {F32}
    assert all(seen), [len(s) for s in seen]
