"""The port's fused-projection BiLSTM layer (plain versions, CPU) against
the JAX package's in interpret mode: the residual-saving forward
(_bdp_fwd) and the lean one (bilstm_sequence_fused -> _bdp_infer), the
gradients of BiLSTMFusedFunction against jax.vjp of
bilstm_sequence_fused, the LSTM layer's fused and composed routes
against each other and against JAX's LSTM with fusion on, and the
fusion plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.models import layers as jl
from speechsplit_tpu.ops import pallas_lstm
from speechsplit_tpu_torch.models import layers as tl
from speechsplit_tpu_torch.ops import _build, bilstm
from tests.jax_interpret import at_test_fold

T, H, I = 10, 32, 16
TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    at_test_fold(monkeypatch)
    pallas_lstm.FORCE_INTERPRET = True
    saved = (pallas_lstm.RESIDUAL_DTYPE, pallas_lstm.PROJ_FUSION,
             bilstm.PROJ_FUSION)
    pallas_lstm.RESIDUAL_DTYPE = jnp.float32
    yield
    pallas_lstm.FORCE_INTERPRET = False
    (pallas_lstm.RESIDUAL_DTYPE, pallas_lstm.PROJ_FUSION,
     bilstm.PROJ_FUSION) = saved


def _inputs(b, h=H, i=I):
    """JAX layouts: x [T, b, i], wi [i, 4h], bias [4h], w [h, 4h]; and
    the cotangents dh_f, dh_b [T, b, h]."""
    rng = np.random.RandomState(100 * h + 10 * b + i)
    x = rng.randn(T, b, i).astype(np.float32)
    wi = [(rng.randn(i, 4 * h) / np.sqrt(i)).astype(np.float32)
          for _ in "fb"]
    bias = [(0.1 * rng.randn(4 * h)).astype(np.float32) for _ in "fb"]
    w = [(rng.randn(h, 4 * h) / np.sqrt(h)).astype(np.float32) for _ in "fb"]
    dh = [rng.randn(T, b, h).astype(np.float32) for _ in "fb"]
    return [x, *wi, *bias, *w], dh


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _port_args(args, requires_grad=False):
    """JAX-layout arguments -> the port's (x, wi_f, wi_b, b_f, b_b, w_f,
    w_b), the weights transposed to torch's layouts."""
    out = [_t(a.T if k in (1, 2, 5, 6) else a) for k, a in enumerate(args)]
    return [a.requires_grad_(requires_grad) for a in out]


def _jax_plan_fuses(b, h=H, i=I):
    pallas_lstm.PROJ_FUSION = "auto"
    return pallas_lstm.fused_proj_plan(T, b, h, i, jnp.float32)


SHAPES = pytest.mark.parametrize(
    "b,h,i", [(8, H, I), (16, H, I), (8, 8, 40), (16, 5, 33)])


@SHAPES
def test_forward_reference_matches_bdp_fwd(b, h, i):
    args, _ = _inputs(b, h, i)
    assert _jax_plan_fuses(b, h, i)  # the Pallas fused kernel is compared
    want = pallas_lstm._bdp_fwd(*map(jnp.asarray, args),
                                residual_dtype=jnp.float32)
    got = bilstm.bilstm_fused_forward_reference(*_port_args(args))
    assert len(got) == len(want) == 6
    for g, r in zip(got, want):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)


@SHAPES
def test_lean_reference_matches_bilstm_sequence_fused(b, h, i):
    args, _ = _inputs(b, h, i)
    assert _jax_plan_fuses(b, h, i)
    want = pallas_lstm.bilstm_sequence_fused(*map(jnp.asarray, args))
    got = bilstm.bilstm_sequence_fused(*_port_args(args))
    assert all(g.grad_fn is None for g in got)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL)
    assert not any(bilstm.LAUNCHES.values())


def _grads_match(port_op, jax_op, node, b, h=H, i=I):
    args, dh = _inputs(b, h, i)
    outs, vjp = jax.vjp(jax_op, *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, dh)))  # dx, dwi_f, dwi_b, db_f, ...
    inputs = _port_args(args, requires_grad=True)
    got_h = port_op(*inputs, torch.float32)
    assert type(got_h[0].grad_fn).__name__ == node
    got = torch.autograd.grad(got_h, inputs, [_t(x) for x in dh])
    for g, r in zip(got_h, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   atol=TOL)
    for k, (g, r) in enumerate(zip(got, want)):
        r = np.asarray(r)
        if k in (1, 2, 5, 6):  # weights in torch's layouts
            r = r.T
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, rtol=TOL)
    assert not any(bilstm.LAUNCHES.values())


@SHAPES
def test_fused_function_grads_match_jax_vjp(b, h, i):
    assert _jax_plan_fuses(b, h, i)
    _grads_match(bilstm.bilstm_sequence_fused,
                 pallas_lstm.bilstm_sequence_fused,
                 "BiLSTMFusedFunctionBackward", b, h, i)


def _lstm_pair(rng, b, layers, in_features=I):
    x = rng.randn(b, T, in_features).astype(np.float32)
    mod = jl.LSTM(H, num_layers=layers, bidirectional=True)
    params = mod.init(jax.random.PRNGKey(4), x)["params"]
    ours = tl.LSTM(in_features, H, layers, torch.Generator(),
                   residual_dtype=torch.float32)
    state = {}
    for name, value in params.items():
        kind, side, sfx = name.split("_", 2)
        key = f"{'weight' if kind == 'w' else 'bias'}_{side}_{sfx}"
        state[key] = _t(value).T if kind == "w" else _t(value)
    ours.load_state_dict(state)
    return x, mod, params, ours


def _graph_nodes(tensor):
    """The names of every autograd node behind ``tensor``."""
    names, todo, seen = set(), [tensor.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def _spy(monkeypatch, name):
    calls = []
    real = getattr(bilstm, name)

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(bilstm, name, spy)
    return calls


@pytest.mark.parametrize("b", [8, 6])
def test_lstm_routes_agree_with_each_other_and_jax(rng, monkeypatch, b):
    """The port's LSTM with fusion on (no grad: the lean fused op; under
    autograd: BiLSTMFusedFunction) and with fusion off give the same
    values and gradients, and match JAX's LSTM with fusion on. At B=6 JAX's plan refuses (B % 8) and JAX composes, while
    the port still fuses: the route differs, the numbers do not."""
    x, mod, params, ours = _lstm_pair(rng, b, 2)
    target = rng.randn(b, T, 2 * H).astype(np.float32)
    assert _jax_plan_fuses(b, i=2 * H) == (b % 8 == 0)

    def jax_loss(p):
        return jnp.mean(jnp.square(mod.apply({"params": p}, x) - target))

    want_out = mod.apply({"params": params}, x)
    want_grads = jax.grad(jax_loss)(params)
    want_grads = {
        f"{'weight' if n[0] == 'w' else 'bias'}_{n.split('_', 2)[1]}_"
        f"{n.split('_', 2)[2]}": np.asarray(v).T if n[0] == "w" else
        np.asarray(v) for n, v in want_grads.items()}

    lean = _spy(monkeypatch, "bilstm_sequence_fused_reference")
    routes = {}
    for fusion, node in (("auto", "BiLSTMFusedFunctionBackward"),
                         ("off", "BiLSTMFunctionBackward")):
        bilstm.PROJ_FUSION = fusion
        with torch.no_grad():
            plain = ours(_t(x))
        ours.zero_grad()
        out = ours(_t(x))
        assert node in _graph_nodes(out)
        torch.mean(torch.square(out - _t(target))).backward()
        routes[fusion] = (plain, out.detach(), {
            k: p.grad.clone() for k, p in ours.named_parameters()})
    # the lean fused op ran once a layer, only with fusion on
    assert len(lean) == 2
    for plain, out, grads in routes.values():
        np.testing.assert_allclose(plain.numpy(), np.asarray(want_out),
                                   atol=TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=TOL)
        for key, ref in want_grads.items():
            np.testing.assert_allclose(grads[key].numpy(), ref, atol=TOL,
                                       rtol=TOL, err_msg=key)
    fused, off = routes.values()
    np.testing.assert_allclose(fused[1].numpy(), off[1].numpy(), atol=1e-6)


def test_fused_proj_plan():
    bilstm.PROJ_FUSION = "off"
    assert not bilstm.fused_proj_plan(192, 16, 512, 1024, torch.float32)
    bilstm.PROJ_FUSION = "auto"
    for b, h, i in ((16, 512, 1024), (56, 512, 164), (16, 8, 16),
                    (8, 256, 66), (1, 1, 1), (bilstm.MAX_FUSED_BATCH, 512, 7)):
        assert bilstm.fused_proj_plan(192, b, h, i, torch.float32)
    # B=28 fuses in the port; JAX's sublane rule refuses it
    assert bilstm.fused_proj_plan(192, 28, 512, 1024, torch.float32)
    pallas_lstm.PROJ_FUSION = "auto"
    assert not pallas_lstm.fused_proj_plan(192, 28, 512, 1024, jnp.float32)
    assert not bilstm.fused_proj_plan(192, 16, 513, 1024, torch.float32)
    assert not bilstm.fused_proj_plan(
        192, bilstm.MAX_FUSED_BATCH + 1, 512, 1024, torch.float32)
    # a bfloat16 W_hh (bfloat16 compute) fuses where float32 does, as in
    # JAX at a batch its bfloat16 tiles take (B a multiple of 16)
    assert bilstm.fused_proj_plan(192, 16, 512, 1024, torch.bfloat16)
    assert pallas_lstm.fused_proj_plan(192, 16, 512, 1024, jnp.bfloat16)
    assert bilstm.fused_proj_plan(192, 28, 512, 1024, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bilstm.fused_proj_plan(192, 16, 512, 1024, torch.float16)
    bilstm.PROJ_FUSION = "on"
    with pytest.raises(ValueError, match="PROJ_FUSION"):
        bilstm.fused_proj_plan(192, 16, 512, 1024, torch.float32)


def test_max_fused_batch_is_the_kernels_own():
    """The batch limit has one owner, the kernel source, which checks it
    against its shared-memory plan at compile time."""
    assert bilstm.MAX_FUSED_BATCH == _build.source_constant(
        "bilstm_infer", "kMaxFusedBatch") == 487
    with pytest.raises(RuntimeError, match="kNoSuchLimit"):
        _build.source_constant("bilstm_infer", "kNoSuchLimit")


def test_fused_checks_reject_what_the_kernel_does_not_take():
    args = _port_args(_inputs(8)[0])
    bilstm._check_fused(*args)
    # bfloat16 compute: x and the weights bfloat16, the biases float32
    bf16 = [a.bfloat16() if k not in (3, 4) else a
            for k, a in enumerate(args)]
    bilstm._check_fused(*bf16)
    # the op takes x, W_ih and W_hh each in either dtype (it streams x in
    # W_ih's, fused_input, and runs a mixed weight pair on the merged
    # kernels); the fused kernels take them in one dtype
    mixed = ((args[0].bfloat16(), *args[1:]),
             (*args[:5], *(a.bfloat16() for a in args[5:])),
             (*bf16[:5], *args[5:]))
    for m in mixed:
        bilstm.check_fused_compute(*m)
        with pytest.raises(ValueError, match="in one dtype"):
            bilstm._check_fused(*m)
    with pytest.raises(ValueError, match="each weight pair"):
        bilstm.check_fused_compute(*args[:2], args[2].bfloat16(), *args[3:])
    with pytest.raises(ValueError, match="float32 biases"):
        bilstm._check_fused(*bf16[:3], args[3].bfloat16(), *bf16[4:])
    with pytest.raises(ValueError, match="wi_b"):
        bilstm._check_fused(args[0], args[1], args[2][:, :-1].contiguous(),
                            *args[3:])
    with pytest.raises(ValueError, match="contiguous"):
        bilstm._check_fused(args[0].transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="tensors on"):
        bilstm.bilstm_sequence_fused(args[0].to("meta"), *args[1:])
