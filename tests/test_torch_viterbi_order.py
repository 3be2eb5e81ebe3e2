"""The pitch decoder's kernel (``csrc/viterbi.cu``) takes its steps in
another order than the plain loop: each lane's transition weights are
computed a step ahead; the previous costs of the padded predecessors
are +inf and the unvoiced lane's weights 0, so every lane takes the same
min; for K <= kPairMaxK two lanes hold a state, each taking the min of 6
predecessors by a tree of (value, index) pairs (fminf for the value, a
right half winning only when strictly smaller, an odd last value carried
up) before the two exchange their pairs, the lower indices winning a
tie; past kPairMaxK one lane takes 32 padded predecessors; the final
state comes from a butterfly over the warp; and the backtrace from
kTraceChunks chunks, each lane composing its chunk's maps for every
state before the chunks' top states are chained and each lane writes
its own. A CUDA kernel does not run here, so that order is emulated in
numpy float32 (each add, product and difference rounded once, as
``__fadd_rn``, ``__fmul_rn`` and ``__fsub_rn``) and held to JAX's
``_viterbi_scan`` and to ``viterbi_decode_reference``, bit for bit; the
source's constants are read against the wrapper's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu.ops import pitch as jpitch
from speechsplit_tpu_torch.ops import _build, pitch
from tests.test_torch_pitch import KMAX, _decoder_field

TRACE_CHUNKS = _build.source_constant("viterbi", "kTraceChunks")
SHARED_BACK_BYTES = _build.source_constant("viterbi", "kSharedBackBytes")
MAX_STATES = _build.source_constant("viterbi", "kMaxStates")
PAIR_MAX_K = _build.source_constant("viterbi", "kPairMaxK")
INF = np.float32(np.inf)
LANES = np.arange(32)
# JAX's serial decoder, compiled once a shape (the kinds share it)
VITERBI_SCAN = jax.jit(jpitch._viterbi_scan, static_argnums=(2, 3))


def _plan(k: int) -> tuple[int, int]:
    """(KP, NP): the lanes a copy of the states takes (16: two lanes a
    state) and the predecessors a lane takes (viterbi_launch's plans)."""
    return (16, PAIR_MAX_K // 2) if k <= PAIR_MAX_K else (32, 32)


def tree_argmin(c):
    """[lanes, N] -> (min, first argmin) a lane by the kernel's tree."""
    idx = np.broadcast_to(np.arange(c.shape[1]), c.shape)
    while c.shape[1] > 1:
        n = c.shape[1]
        left, right = c[:, 0:n - 1:2], c[:, 1:n:2]
        take = right < left
        pairs_idx = np.where(take, idx[:, 1:n:2], idx[:, 0:n - 1:2])
        pairs = np.fmin(left, right)
        if n % 2:  # the odd last value goes up as it is
            pairs = np.concatenate([pairs, c[:, -1:]], axis=1)
            pairs_idx = np.concatenate([pairs_idx, idx[:, -1:]], axis=1)
        c, idx = pairs, pairs_idx
    return c[:, 0], idx[:, 0]


def warp_argmin(best, state):
    """The final state: the kernel's butterfly over 32 lanes, (value,
    index) compared lexicographically."""
    off = 16
    while off:
        ob, os_ = best[LANES ^ off], state[LANES ^ off]
        take = (ob < best) | ((ob == best) & (os_ < state))
        best, state = np.where(take, ob, best), np.where(take, os_, state)
        off //= 2
    assert (state == state[0]).all()
    return int(state[0])


def kernel_order(local_v, local_u, log_lag, fw, tc):
    """One utterance's states [T] in the kernel's order of operations.
    local_v, log_lag [T, K], local_u [T] float32."""
    t_len, k = local_v.shape
    kp, n_pred = _plan(k)
    fw, tc = np.float32(fw), np.float32(tc)
    state = LANES % kp  # the state a lane holds
    first = LANES // kp * n_pred  # its first predecessor
    preds = first[:, None] + np.arange(n_pred)[None, :]  # [lane, n]
    voiced = state < k
    state_lane = state <= k
    # the log-lag ring's rows, padded columns 0; a lane's own log lag
    # (the unvoiced lane and past it read column K, a padded 0)
    ll_rows = np.zeros((t_len, kp), np.float32)
    ll_rows[:, :k] = log_lag
    own = np.minimum(state, k)
    fw_lane = np.where(voiced, fw, np.float32(0.0)).astype(np.float32)
    loc = np.zeros((t_len, kp), np.float32)
    loc[:, :k] = local_v
    loc[:, k] = local_u

    def weights(t):
        """Step t's w[lane, n] = fw * |ll_t[own] - ll_{t-1}[preds]|."""
        diff = ll_rows[t, own][:, None] - ll_rows[t - 1][preds]
        return fw_lane[:, None] * np.abs(diff)

    cost = np.where(state_lane, loc[0, own], INF).astype(np.float32)
    backs = np.zeros((max(t_len - 1, 0), k + 1), np.int64)
    w = weights(min(1, t_len - 1)) if t_len > 1 else None
    for t in range(1, t_len):
        mine = np.where(voiced, cost, INF).astype(np.float32)
        p = mine[preds]  # the shuffles: lane first + n holds state first + n
        prev_u = cost[k]
        w_next = weights(min(t + 1, t_len - 1))  # off the chain
        best, arg = tree_argmin(p + w)
        arg = arg + first
        if kp == 16:  # the two lanes of a state exchange their pairs
            other, other_arg = best[LANES ^ 16], arg[LANES ^ 16]
            take = np.where(first == 0, other < best, ~(best < other))
            best = np.fmin(best, other)
            arg = np.where(take, other_arg, arg)
        x = np.where(voiced, best, best + tc).astype(np.float32)
        y = np.where(voiced, prev_u + tc, prev_u).astype(np.float32)
        take = x <= y
        cost = (loc[t, own] + np.where(take, x, y)).astype(np.float32)
        backs[t - 1] = np.where(take, arg, k)[:k + 1]
        w = w_next
    end = warp_argmin(np.where(state_lane, cost, INF), state)
    return chunked_backtrace(backs, end, t_len)


def chunked_backtrace(backs, end, t_len):
    """The states from the backpointer rows (row r maps frame r + 1's
    state to frame r's) as the kernel's warp takes them."""
    n, states_n = backs.shape
    span = -(-n // TRACE_CHUNKS)
    bounds = [(min(l * span, n), min(min(l * span, n) + span, n))
              for l in range(TRACE_CHUNKS)]
    maps = []
    for lo, hi in bounds:  # each lane's map, every state at once
        m = np.arange(states_n)
        for r in range(hi - 1, lo - 1, -1):
            m = backs[r][m]
        maps.append(m)
    tops, e = [0] * TRACE_CHUNKS, end
    for l in range(TRACE_CHUNKS - 1, -1, -1):
        tops[l] = e
        e = maps[l][e]
    states = np.zeros(t_len, np.int64)
    states[n] = end
    for (lo, hi), s in zip(bounds, tops):
        for r in range(hi - 1, lo - 1, -1):
            s = backs[r][s]
            states[r] = s
    return states


def _field(t, kind, k):
    """A (lag, score) [T, K] field from ``_decoder_field``'s (12 columns
    a draw; K = 31 from three draws). ``voiced_equal``: its ``equal``
    field with every score at 0.875, so that every voiced path ties and
    is cheaper than the unvoiced one (``equal``'s scores of 0.5 decode
    unvoiced throughout, leaving the voiced ties untried)."""
    base = "equal" if kind == "voiced_equal" else kind
    draws = [_decoder_field(t, 11 + t + 97 * i, base)
             for i in range(-(-k // 12))]
    lag = np.concatenate([d[0] for d in draws], axis=1)[:, :k]
    score = np.concatenate([d[1] for d in draws], axis=1)[:, :k]
    if kind == "voiced_equal":
        score[:] = 0.875
    return np.ascontiguousarray(lag), np.ascontiguousarray(score)


@pytest.mark.parametrize("k", [12, MAX_STATES - 1])
@pytest.mark.parametrize("t", [1, 2, 33, 70, 257])
@pytest.mark.parametrize("kind", ["random", "unusable", "equal",
                                  "voiced_equal"])
def test_kernel_order_equals_viterbi_scan(kind, t, k):
    lag, score = _field(t, kind, k)
    params = pitch.PitchParams()
    _, local_v, local_u, log_lag = pitch._local_costs(
        torch.from_numpy(lag)[None], torch.from_numpy(score)[None], KMAX,
        params)
    got = kernel_order(local_v[0].numpy(), local_u[0].numpy(),
                       log_lag[0].numpy(), params.freq_weight,
                       params.trans_cost)
    want = pitch.viterbi_decode_reference(local_v, local_u, log_lag,
                                          params.freq_weight,
                                          params.trans_cost)[0].numpy()
    np.testing.assert_array_equal(got, want)
    # JAX's decoder, through the shared tail (pitch.py:550-562)
    best_j, voiced_j = VITERBI_SCAN(jnp.asarray(lag), jnp.asarray(score),
                                    KMAX, jpitch.PitchParams())
    state_c = np.clip(got, 0, k - 1)
    usable = score > params.cand_thresh
    voiced = (got < k) & usable[np.arange(t), state_c]
    np.testing.assert_array_equal(voiced, np.asarray(voiced_j))
    np.testing.assert_array_equal(lag[np.arange(t), state_c],
                                  np.asarray(best_j))


def test_kernel_constants_are_the_wrappers():
    """The wrapper's plan border and state limit are the source's, and the
    border falls where the shared plan's backpointers fill its bytes."""
    assert pitch.SHARED_BACK_BYTES == SHARED_BACK_BYTES
    assert pitch.MAX_STATES == MAX_STATES == 32
    assert TRACE_CHUNKS == 32  # a lane a chunk
    for k in (12, MAX_STATES - 1):
        last = SHARED_BACK_BYTES // (k + 1) + 1
        assert pitch.shared_plan(last, k) and not pitch.shared_plan(
            last + 1, k)
    assert pitch.shared_plan(1, 12)  # no backpointers at all
