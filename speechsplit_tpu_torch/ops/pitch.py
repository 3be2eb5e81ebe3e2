"""Batched NCCF + Viterbi pitch tracking (counterpart of
speechsplit_tpu/ops/pitch.py; the reference runs RAPT on the host,
make_spect_f0.py:64).

Log-F0 a frame, one frame a STFT hop (N // hop + 1 frames), unvoiced
frames -1e10, search range [lo, hi] Hz an utterance (the gender ranges
of make_spect_f0.py:40-45):

1. NCCF: the mean-subtracted normalized cross-correlation of every
   frame with itself at lags [fs/600, fs/50], for all frames of all
   utterances at once (an rfft correlation, or with ``nccf_by_conv`` one
   grouped convolution; window sums from prefix sums).
2. Candidates: the top K local NCCF maxima a frame (a stable descending
   sort, or with ``topk_by_sort=False`` K argmax passes), parabolic lag
   refinement.
3. Viterbi over frames: K voiced states and one unvoiced state. The
   serial decoder of JAX's ``_viterbi_scan`` (pitch.py:497-562) by
   default, or JAX's parallel (``parallel_viterbi``, an associative
   scan in JAX's association order) and block (``block_viterbi > 1``)
   decoders, which are stock tensor ops on any device as in XLA.

The serial decoder is the one recurrence of the front end. On CUDA
tensors it runs in ``csrc/viterbi.cu`` (:func:`viterbi_decode`: a warp an
utterance, one launch for the batch, the forward pass and a warp-wide
backtrace; the backpointers in shared memory while :func:`shared_plan`
holds, about four minutes of audio at K = 12, else in device memory);
on CPU tensors its plain version runs, the T-step loop in JAX's order of
operations, which the tests hold to JAX.

Candidate ties: ``jax.lax.top_k`` breaks them toward the lower index, and
masked lags (all -2.0) tie often, so the top K come from a stable
descending ``torch.sort`` (or from argmax passes, which take the first
maximum).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from speechsplit_tpu_torch.ops import _build
from speechsplit_tpu_torch.ops.stft import exact_float32

UNVOICED_LOG_F0 = -1e10  # sentinel shared with the reference pipeline

# kernel launches since the last reset; the main path's proof that it ran
LAUNCHES = {"viterbi_decode": 0}
# the most states (K voiced + unvoiced) the kernel takes: a warp's lanes
MAX_STATES = _build.source_constant("viterbi", "kMaxStates")
# the kernel keeps an utterance's (T-1) x (K+1) int8 backpointers in shared
# memory up to this many bytes, past it in a device-memory scratch
SHARED_BACK_BYTES = _build.source_constant("viterbi", "kSharedBackBytes")


class PitchParams(NamedTuple):
    """Tracker constants (the JAX package's fields and defaults)."""

    window: int = 120          # correlation window, 7.5 ms @ 16 kHz
    num_cands: int = 12        # voiced candidates per frame
    cand_thresh: float = 0.3   # min NCCF for a candidate to count
    lag_weight: float = 0.3    # prefer shorter lags (higher F0)
    freq_weight: float = 0.25  # octave-jump transition penalty
    voice_bias: float = 0.0    # bias toward voiced decisions
    trans_cost: float = 0.3    # voiced<->unvoiced switch cost
    # the associative-scan decoder (_viterbi_parallel) instead of the
    # serial one
    parallel_viterbi: bool = False
    # > 1: the radix-k block decoder (_viterbi_block); 0/1 the serial one
    block_viterbi: int = 0
    # the top K by a stable sort (True) or K argmax passes (False); equal
    topk_by_sort: bool = True
    # the NCCF numerator as one grouped convolution instead of an FFT
    nccf_by_conv: bool = False


def _windows(x: torch.Tensor, n_frames: int, hop: int,
             span: int) -> torch.Tensor:
    """out[..., t, j] = x[..., t*hop + j] for t < n_frames, j < span;
    zeros past the end of x (JAX ``strided_windows``)."""
    need = (n_frames - 1) * hop + span
    if need > x.shape[-1]:
        x = F.pad(x, (0, need - x.shape[-1]))
    return x.unfold(-1, span, hop)[..., :n_frames, :]


def _prefix_sum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive float32 prefix sum of x [B, N] along N in the order XLA
    takes for ``jnp.cumsum`` on the CPU: chunks of ``base`` summed in
    sequence, the chunk totals scanned the same way (recursively) and
    added to their successors. The window sums of :func:`_nccf` are
    differences of prefix entries of about the utterance's whole energy,
    so the rounding of the sum shows in quiet frames: in this order they
    round as the JAX package's do. (``torch.cumsum`` sums in another
    order, in float64 on the CPU.)"""
    batch, n = x.shape
    chunks = -(-n // base)
    xs = F.pad(x, (0, chunks * base - n)).reshape(batch, chunks, base)
    cols = [xs[..., 0]]
    for j in range(1, base):
        cols.append(cols[-1] + xs[..., j])
    within = torch.stack(cols, dim=-1)  # [B, chunks, base]
    if chunks > 1:
        carry = _prefix_sum(within[..., -1], base)
        within = within + F.pad(carry[:, :-1], (1, 0))[..., None]
    return within.reshape(batch, chunks * base)[:, :n]


def _window_prefix_sums(x: torch.Tensor):
    """(sum, energy) prefixes of x [B, N], each [B, N+1] with a leading
    zero: one :func:`_prefix_sum` over both, stacked on the batch."""
    batch = x.shape[0]
    both = _prefix_sum(torch.cat([x, x * x]))
    both = torch.cat([both.new_zeros(2 * batch, 1), both], dim=-1)
    return both[:batch], both[batch:]


def _nccf(x: torch.Tensor, n_frames: int, hop: int, window: int, kmin: int,
          kmax: int, by_conv: bool = False) -> torch.Tensor:
    """Mean-subtracted NCCF of every frame: x [B, N] (zero-padded so that
    (n_frames-1)*hop + window + kmax <= N) -> [B, n_frames, kmax-kmin+1].
    Window means leave both legs through prefix sums:
    sum (a-ā)(b-b̄) = sum ab - W·ā·b̄. The numerator sum_n x[n] x[n+k]
    comes from an rfft correlation, or with ``by_conv`` from one grouped
    convolution (pitch.py:117-133): every frame its own group, its first
    ``window`` samples its filter, a valid correlation over its span."""
    batch = x.shape[0]
    n_lags = kmax - kmin + 1
    span = window + kmax
    frames = _windows(x, n_frames, hop, span)  # [B, T, span]

    # the correlation in float64: where a lagged window is silent (the
    # zero padding past an utterance's end, digital silence) the
    # normalization below sits near its 1e-12 floor and multiplies the
    # numerator by up to 1e6, so float32 rounding there (which differs
    # between cuFFT, pocketfft, cuDNN and JAX's FFT and convolution)
    # would decide the frame's candidates; in float64 it is 1e-9 of a
    # float32 ulp, and the card and the CPU agree
    frames64 = frames.double()
    if by_conv:
        groups = batch * n_frames
        with exact_float32():
            out = F.conv1d(frames64.reshape(1, groups, span),
                           frames64[..., :window].reshape(groups, 1, window),
                           groups=groups)  # [1, B*T, kmax + 1]
        num = out.reshape(batch, n_frames, -1)[..., kmin : kmax + 1]
    else:
        nfft = 1 << (span + window - 1).bit_length()
        keep = torch.arange(span, device=x.device) < window
        short = torch.where(keep, frames64, torch.zeros(
            (), dtype=torch.float64, device=x.device))
        spec_l = torch.fft.rfft(frames64, n=nfft, dim=-1)
        spec_s = torch.fft.rfft(short, n=nfft, dim=-1)
        corr = torch.fft.irfft(torch.conj(spec_s) * spec_l, n=nfft, dim=-1)
        num = corr[..., kmin : kmax + 1]
    num = num.to(x.dtype)

    sum_prefix, energy_prefix = _window_prefix_sums(x)
    starts = torch.arange(n_frames, device=x.device) * hop

    def seg(prefix, base):
        return _windows(prefix[:, base:], n_frames, hop, n_lags)

    s_k = seg(sum_prefix, kmin + window) - seg(sum_prefix, kmin)
    s_0 = (sum_prefix[:, starts + window] - sum_prefix[:, starts])[..., None]
    e_k = seg(energy_prefix, kmin + window) - seg(energy_prefix, kmin)
    e_0 = (energy_prefix[:, starts + window]
           - energy_prefix[:, starts])[..., None]

    w = float(window)
    num_c = num - s_0 * s_k / w
    e_0c = torch.clamp(e_0 - s_0 * s_0 / w, min=0.0)
    e_kc = torch.clamp(e_k - s_k * s_k / w, min=0.0)
    return num_c * torch.rsqrt(e_0c * e_kc + 1e-12)


def _top_k_by_max(x: torch.Tensor, k: int):
    """The top k of each row of x [..., L] by k argmax passes
    (pitch.py:170-194): each pass takes the first maximum (``torch.argmax``
    returns the first, as ``jnp.argmax`` does) and masks it to -inf, so
    the values descend and ties go to the lower index, as
    ``jax.lax.top_k``'s. Returns (values, indices) [..., k]."""
    iota = torch.arange(x.shape[-1], device=x.device)
    minus_inf = torch.full((), -torch.inf, dtype=x.dtype, device=x.device)
    vals, idx = [], []
    cur = x
    for _ in range(k):
        pos = cur.argmax(dim=-1, keepdim=True)
        vals.append(torch.gather(cur, -1, pos))
        idx.append(pos)
        cur = torch.where(iota == pos, minus_inf, cur)
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def _candidates(nccf: torch.Tensor, kmin: int, params: PitchParams):
    """The top K local maxima a frame with parabolic refinement:
    nccf [..., T, L] -> (lag [..., T, K] float, score [..., T, K])."""
    n_lags = nccf.shape[-1]
    left = F.pad(nccf[..., :-1], (1, 0), value=-2.0)
    right = F.pad(nccf[..., 1:], (0, 1), value=-2.0)
    is_peak = (nccf >= left) & (nccf > right)
    masked = torch.where(is_peak, nccf, torch.full((), -2.0,
                                                   device=nccf.device))
    k = params.num_cands
    if params.topk_by_sort:
        score, pos = torch.sort(masked, dim=-1, descending=True, stable=True)
        score, pos = score[..., :k], pos[..., :k]
    else:
        score, pos = _top_k_by_max(masked, k)

    pos_c = pos.clamp(1, n_lags - 2)
    ym = torch.gather(left, -1, pos_c)
    y0 = torch.gather(nccf, -1, pos_c)
    yp = torch.gather(right, -1, pos_c)
    denom = ym - 2.0 * y0 + yp
    zero = torch.zeros((), device=nccf.device)
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (ym - yp) / denom, zero)
    delta = delta.clamp(-0.5, 0.5)
    lag = pos.float() + torch.where(pos == pos_c, delta, zero)
    return lag + kmin, score


def _local_costs(lag: torch.Tensor, score: torch.Tensor, kmax: int,
                 params: PitchParams):
    """(usable [..., K], local_v [..., K], local_u [...], log_lag [..., K])
    a frame, as JAX's ``_local_costs`` (pitch.py:395-406)."""
    usable = score > params.cand_thresh
    lag_term = 1.0 - params.lag_weight * lag / kmax
    local_v = torch.where(usable, 1.0 - score * lag_term,
                          torch.full((), 1e6, device=lag.device))
    local_u = params.voice_bias + torch.clamp(score.amax(dim=-1), min=0.0)
    log_lag = torch.log(torch.clamp(lag, min=1.0))
    return usable, local_v, local_u, log_lag


def viterbi_decode_reference(local_v: torch.Tensor, local_u: torch.Tensor,
                             log_lag: torch.Tensor, freq_weight: float,
                             trans_cost: float) -> torch.Tensor:
    """The plain version of the decoder kernel: JAX's ``_viterbi_scan``
    step loop and backtrace, for a batch, in its order of operations.
    local_v, log_lag [B, T, K], local_u [B, T] float32 -> the state of
    every frame [B, T] int32 (K is unvoiced)."""
    batch, t_len, k = local_v.shape
    cost = torch.cat([local_v[:, 0], local_u[:, :1]], dim=1)  # [B, K+1]
    k_col = torch.full((), k, dtype=torch.int64, device=local_v.device)
    backs = []
    for t in range(1, t_len):
        ll, prev_ll = log_lag[:, t], log_lag[:, t - 1]
        trans_vv = freq_weight * (ll[:, None, :] - prev_ll[:, :, None]).abs()
        cost_from_v = cost[:, :k, None] + trans_vv  # [B, K_prev, K_cur]
        cost_from_u = cost[:, k:] + trans_cost  # [B, 1]
        best_v_prev = cost_from_v.amin(dim=1)
        arg_v_prev = cost_from_v.argmin(dim=1)
        new_v = local_v[:, t] + torch.minimum(best_v_prev, cost_from_u)
        arg_v = torch.where(best_v_prev <= cost_from_u, arg_v_prev, k_col)

        prev_v = cost[:, :k]
        to_u_from_v = prev_v.amin(dim=1, keepdim=True) + trans_cost
        arg_u_from_v = prev_v.argmin(dim=1, keepdim=True)
        prev_u = cost[:, k:]
        new_u = local_u[:, t : t + 1] + torch.minimum(to_u_from_v, prev_u)
        arg_u = torch.where(to_u_from_v <= prev_u, arg_u_from_v, k_col)

        cost = torch.cat([new_v, new_u], dim=1)
        backs.append(torch.cat([arg_v, arg_u], dim=1))
    state = cost.argmin(dim=1, keepdim=True)  # [B, 1]
    states = [state]
    for back in reversed(backs):
        state = torch.gather(back, 1, state)
        states.append(state)
    return torch.cat(states[::-1], dim=1).to(torch.int32)


def _check(local_v, local_u, log_lag) -> None:
    """The kernel's inputs: float32, contiguous, [B, T, K] and [B, T],
    K + 1 states on at most ``MAX_STATES`` lanes."""
    if local_v.dim() != 3 or log_lag.shape != local_v.shape or (
            local_u.shape != local_v.shape[:2]):
        raise ValueError(
            f"viterbi_decode takes local_v, log_lag [B, T, K] and local_u "
            f"[B, T]: got {tuple(local_v.shape)}, {tuple(log_lag.shape)}, "
            f"{tuple(local_u.shape)}")
    k = local_v.shape[-1]
    if not 1 <= k < MAX_STATES:
        raise ValueError(
            f"viterbi_decode takes 1..{MAX_STATES - 1} candidates a frame "
            f"(K + 1 states on a warp's lanes), got K={k}")
    if local_v.shape[1] < 1:
        raise ValueError("viterbi_decode needs at least one frame")
    for name, x in (("local_v", local_v), ("local_u", local_u),
                    ("log_lag", log_lag)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(
                f"viterbi_decode takes contiguous float32 tensors: {name} "
                f"is {x.dtype}, contiguous={x.is_contiguous()}")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a library built from ``csrc/viterbi.cu``
    (the port's, or a probe build of it)."""
    # local_v, local_u, log_lag, back, states, B, T, K, freq_weight,
    # trans_cost, device, stream
    lib.viterbi_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.viterbi_launch.restype = ctypes.c_int
    lib.viterbi_error_string.argtypes = [ctypes.c_int]
    lib.viterbi_error_string.restype = ctypes.c_char_p
    lib.viterbi_shared_bytes.argtypes = [ctypes.c_int] * 2
    lib.viterbi_shared_bytes.restype = ctypes.c_longlong
    return lib


def _library():
    return _bind(_build.load("viterbi"))


def shared_plan(t_len: int, k: int) -> bool:
    """Whether the kernel keeps the backpointers of T frames and K
    candidates in shared memory (else in a device-memory scratch)."""
    return (t_len - 1) * (k + 1) <= SHARED_BACK_BYTES


def _launch(lib: ctypes.CDLL, local_v: torch.Tensor, local_u: torch.Tensor,
            log_lag: torch.Tensor, freq_weight: float,
            trans_cost: float) -> torch.Tensor:
    """One launch of ``lib``'s decoder on checked inputs; the states. The
    [B, T-1, K+1] int8 backpointer scratch is allocated for the
    device-memory plan only."""
    batch, t_len, k = local_v.shape
    device = local_v.device
    back = None if shared_plan(t_len, k) else torch.empty(
        batch, t_len - 1, k + 1, dtype=torch.int8, device=device)
    states = torch.empty(batch, t_len, dtype=torch.int32, device=device)
    err = lib.viterbi_launch(
        local_v.data_ptr(), local_u.data_ptr(), log_lag.data_ptr(),
        None if back is None else back.data_ptr(), states.data_ptr(),
        batch, t_len, k,
        float(freq_weight), float(trans_cost), device.index or 0,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "viterbi_decode", lib.viterbi_error_string)
    return states


def viterbi_decode_cuda(local_v: torch.Tensor, local_u: torch.Tensor,
                        log_lag: torch.Tensor, freq_weight: float,
                        trans_cost: float) -> torch.Tensor:
    """Launch ``csrc/viterbi.cu``; arguments and result as
    :func:`viterbi_decode_reference`. The backpointers stay in shared
    memory while :func:`shared_plan` holds, else go to a scratch."""
    _check(local_v, local_u, log_lag)
    states = _launch(_library(), local_v, local_u, log_lag, freq_weight,
                     trans_cost)
    LAUNCHES["viterbi_decode"] += 1
    return states


def viterbi_decode(local_v: torch.Tensor, local_u: torch.Tensor,
                   log_lag: torch.Tensor, freq_weight: float,
                   trans_cost: float) -> torch.Tensor:
    """The serial Viterbi decoder: the kernel on CUDA tensors, the plain
    version on CPU tensors; see :func:`viterbi_decode_reference`."""
    devices = {x.device.type for x in (local_v, local_u, log_lag)}
    if devices == {"cuda"}:
        return viterbi_decode_cuda(local_v, local_u, log_lag, freq_weight,
                                   trans_cost)
    if devices == {"cpu"}:
        return viterbi_decode_reference(local_v, local_u, log_lag,
                                        freq_weight, trans_cost)
    raise ValueError(f"viterbi_decode: tensors on {sorted(devices)}")


def _states_to_output(states: torch.Tensor, lag: torch.Tensor,
                      usable: torch.Tensor, k: int):
    """Shared tail of every decoder (pitch.py:273-280): states [..., T]
    -> (best_lag, voiced); a voiced frame must have had a usable
    candidate."""
    voiced = states < k
    state_c = states.clamp(0, k - 1)[..., None]
    best_lag = torch.gather(lag, -1, state_c)[..., 0]
    has_cand = torch.gather(usable, -1, state_c)[..., 0]
    return best_lag, voiced & has_cand


def _first_frame_states(local_v: torch.Tensor, local_u: torch.Tensor):
    """The state of a one-frame clip: the cheapest of its K + 1 local
    costs, the first on a tie (pitch.py:310-314)."""
    return torch.cat([local_v[:, 0], local_u[:, :1]], dim=-1).argmin(
        dim=-1, keepdim=True)


def _transition_stack(local_v: torch.Tensor, local_u: torch.Tensor,
                      log_lag: torch.Tensor, params: PitchParams):
    """The min-plus transition stack M [B, T-1, S, S] (the arrival's local
    cost folded into the destination column) and the local-cost table
    [B, T, S], S = K + 1 (pitch.py:256-270)."""
    k = log_lag.shape[-1]
    trans_vv = params.freq_weight * (
        log_lag[:, 1:, None, :] - log_lag[:, :-1, :, None]).abs()
    batch, steps = trans_vv.shape[:2]
    m = torch.full((batch, steps, k + 1, k + 1), params.trans_cost,
                   dtype=log_lag.dtype, device=log_lag.device)
    m[..., :k, :k] = trans_vv
    m[..., k, k] = 0.0  # unvoiced -> unvoiced is free
    local = torch.cat([local_v, local_u[..., None]], dim=-1)
    return m + local[:, 1:, None, :], local


def _min_plus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A (x) B)[p, s] = min_m A[p, m] + B[m, s] over the last two dims."""
    return (a[..., :, :, None] + b[..., None, :, :]).amin(dim=-2)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The backtrace's combine under a reversed scan (pitch.py:482-483):
    combine(a, b)[i] = b[a[i]]."""
    return torch.gather(b, -1, a)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 0; ``even`` one longer or as long."""
    pairs = torch.stack([even[: odd.shape[0]], odd], dim=1).flatten(0, 1)
    return torch.cat([pairs, even[odd.shape[0]:]])


def _associative_scan(fn, elems: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``fn`` along dim 0 in the association order of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the halves
    by recursion, fill in the even elements; ``reverse`` flips the
    sequence before and after. The min-plus sums then round as JAX's do,
    and the decoders' costs equal JAX's."""
    def scan(x):
        n = x.shape[0]
        if n < 2:
            return x
        odd = scan(fn(x[0:-1:2], x[1::2]))
        if n % 2 == 0:
            even = fn(odd[:-1], x[2::2])
        else:
            even = fn(odd, x[2::2])
        return _interleave(torch.cat([x[:1], even]), odd)

    if reverse:
        return scan(elems.flip(0)).flip(0)
    return scan(elems)


def _viterbi_parallel(usable, local_v, local_u, log_lag, lag, k: int,
                      params: PitchParams):
    """The associative-scan decoder (pitch.py:408-494): prefix min-plus
    products of the transition stack give every frame's costs, the
    backpointers are a pointwise argmin, and the backtrace is a reversed
    scan of map compositions. Materializes [B, T-1, S, S, S] a level."""
    if lag.shape[1] == 1:
        return _states_to_output(_first_frame_states(local_v, local_u), lag,
                                 usable, k)
    m, local = _transition_stack(local_v, local_u, log_lag, params)
    prefix = _associative_scan(_min_plus, m.transpose(0, 1)).transpose(0, 1)
    v0 = local[:, 0]  # [B, S]
    cost = torch.cat([v0[:, None], (v0[:, None, :, None] + prefix).amin(
        dim=2)], dim=1)  # [B, T, S]
    back = (cost[:, :-1, :, None] + m).argmin(dim=2)  # [B, T-1, S]
    end_state = cost[:, -1].argmin(dim=-1, keepdim=True)  # [B, 1]
    suffix = _associative_scan(_compose, back.transpose(0, 1),
                               reverse=True).transpose(0, 1)
    states = torch.cat([torch.gather(
        suffix, -1, end_state[:, None, :].expand(-1, suffix.shape[1], 1))[
            ..., 0], end_state], dim=1)
    return _states_to_output(states, lag, usable, k)


def _viterbi_block(usable, local_v, local_u, log_lag, lag, k: int,
                   params: PitchParams):
    """The radix-``block_viterbi`` block decoder (pitch.py:282-392): each
    block of transitions pre-combined into prefix composites, a serial
    pass over the ceil((T-1)/radix) block composites, per-frame costs and
    backpointers pointwise, and the backtrace through within-block suffix
    compositions and a serial pass over the block maps."""
    batch, t = lag.shape[:2]
    s = k + 1
    radix = int(params.block_viterbi)
    if t == 1:
        return _states_to_output(_first_frame_states(local_v, local_u), lag,
                                 usable, k)
    m, local = _transition_stack(local_v, local_u, log_lag, params)
    device = m.device

    # the T-1 transitions padded to whole blocks with min-plus identities
    # (0 on the diagonal, 1e12 off it: past any real path's cost, finite
    # in float32 sums)
    n_blocks = -(-(t - 1) // radix)
    pad = n_blocks * radix - (t - 1)
    eye = torch.eye(s, dtype=torch.bool, device=device)
    ident = torch.where(eye, 0.0, 1e12).to(m.dtype)
    m_pad = torch.cat([m, ident.expand(batch, pad, s, s)], dim=1).reshape(
        batch, n_blocks, radix, s, s)

    # within-block prefix composites P[b, j] = M[b, 0] (x) ... (x) M[b, j]
    prefs = [m_pad[:, :, 0]]
    for j in range(1, radix):
        prefs.append(_min_plus(prefs[-1], m_pad[:, :, j]))
    prefix = torch.stack(prefs, dim=2)  # [B, n_blocks, radix, S, S]

    # the serial pass over block composites: block-end costs
    v = local[:, 0]
    entries = [v]
    for blk in range(n_blocks):
        v = (v[:, :, None] + prefix[:, blk, -1]).amin(dim=1)
        entries.append(v)
    entries = torch.stack(entries[:-1], dim=1)  # [B, n_blocks, S]

    # per-frame costs: cost[1 + b*radix + j] = min_p entries[b, p] +
    # P[b, j, p, s]
    inner = (entries[:, :, None, :, None] + prefix).amin(dim=3)
    cost = torch.cat([local[:, :1], inner.reshape(batch, n_blocks * radix,
                                                  s)[:, : t - 1]], dim=1)

    # backpointers pointwise from the unpadded stack
    back = (cost[:, :-1, :, None] + m).argmin(dim=2)  # [B, T-1, S]
    end_state = cost[:, -1].argmin(dim=-1)  # [B]

    # the backtrace: within-block suffix compositions Sfx[b, j] = g_j o
    # ... o g_{radix-1} (identity maps past T-1), then a serial pass over
    # the block maps from the end
    id_map = torch.arange(s, device=device)
    back_pad = torch.cat([back, id_map.expand(batch, pad, s)],
                         dim=1).reshape(batch, n_blocks, radix, s)
    sufs = [back_pad[:, :, radix - 1]]
    for j in range(radix - 2, -1, -1):
        sufs.append(torch.gather(back_pad[:, :, j], -1, sufs[-1]))
    suffix = torch.stack(sufs[::-1], dim=2)  # [B, n_blocks, radix, S]

    state = end_state[:, None]
    boundaries = [None] * n_blocks
    for blk in range(n_blocks - 1, -1, -1):
        boundaries[blk] = state  # the state at frame (blk + 1) * radix
        state = torch.gather(suffix[:, blk, 0], -1, state)
    boundaries = torch.stack(boundaries, dim=1)  # [B, n_blocks, 1]

    # inner states pointwise: state[b*radix + j] = Sfx[b, j][boundary_b]
    inner_states = torch.gather(
        suffix, -1, boundaries[:, :, None, :].expand(-1, -1, radix, 1))[
            ..., 0].reshape(batch, -1)
    states = torch.cat([inner_states, end_state[:, None]], dim=1)[:, :t]
    return _states_to_output(states, lag, usable, k)


def _viterbi_scan(usable, local_v, local_u, log_lag, lag, k: int,
                  params: PitchParams):
    """The serial decoder: :func:`viterbi_decode` and JAX's shared tail."""
    states = viterbi_decode(local_v.contiguous(), local_u.contiguous(),
                            log_lag.contiguous(), params.freq_weight,
                            params.trans_cost).long()
    return _states_to_output(states, lag, usable, k)


def _viterbi(lag: torch.Tensor, score: torch.Tensor, kmax: int,
             params: PitchParams):
    """lag, score [B, T, K] -> (best_lag [B, T], voiced [B, T]). Dispatches
    as JAX does (pitch.py:249-253): the parallel decoder, else the block
    decoder for ``block_viterbi > 1``, else the serial one."""
    k = lag.shape[-1]
    usable, local_v, local_u, log_lag = _local_costs(lag, score, kmax, params)
    if params.parallel_viterbi:
        decode = _viterbi_parallel
    elif params.block_viterbi > 1:
        decode = _viterbi_block
    else:
        decode = _viterbi_scan
    return decode(usable, local_v, local_u, log_lag, lag, k, params)


def track_pitch(
    x: torch.Tensor,
    lengths: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    *,
    sample_rate: int = 16000,
    hop: int = 256,
    n_frames: int | None = None,
    params: PitchParams = PitchParams(),
) -> torch.Tensor:
    """Batched log-F0: x [B, N] zero-padded waveforms, lengths [B] true
    sample counts, lo/hi [B] search bounds in Hz -> [B, T] natural-log F0,
    UNVOICED_LOG_F0 at unvoiced frames and past each length;
    T = N // hop + 1. The static lag span is the widest range (50-600
    Hz); lo/hi mask candidates an utterance."""
    batch, n_samples = x.shape
    if n_frames is None:
        n_frames = n_samples // hop + 1
    kmin = sample_rate // 600
    kmax = sample_rate // 50
    span = params.window + kmax
    x_pad = F.pad(x, (0, (n_frames - 1) * hop + span))

    nccf = _nccf(x_pad, n_frames, hop, params.window, kmin, kmax,
                 by_conv=params.nccf_by_conv)
    lag, score = _candidates(nccf, kmin, params)
    lo = lo.to(x.device, torch.float32)[:, None, None]
    hi = hi.to(x.device, torch.float32)[:, None, None]
    in_range = (lag >= sample_rate / hi) & (lag <= sample_rate / lo)
    score = torch.where(in_range, score, torch.full((), -2.0,
                                                    device=x.device))
    best_lag, voiced = _viterbi(lag, score, kmax, params)
    f0 = sample_rate / torch.clamp(best_lag, min=1.0)
    unvoiced = torch.full((), UNVOICED_LOG_F0, device=x.device)
    logf0 = torch.where(voiced, torch.log(f0), unvoiced)
    frame_valid = (torch.arange(n_frames, device=x.device)[None, :] * hop
                   < lengths.to(x.device)[:, None])
    return torch.where(frame_valid, logf0, unvoiced)
