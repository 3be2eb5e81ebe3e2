"""Streamed conversion, the link probe and two small JAX functions, in
the port against the JAX package at the tiny geometry of
``tests/test_torch_convert.py`` (weights carried by interop).

- ``convert_stream``: each yield within 5e-5 of JAX's ``convert_stream``
  (PARITY.md's conversion bar; JAX runs its Pallas kernels in interpret
  mode at ``TEST_FOLD``) and bit for bit the port's own
  ``convert_batched`` on the same batch; every yield is kept to the end
  of its stream, so a reused host buffer would show. ``compress_fetch=
  True`` yields the port's float32 result rounded to bfloat16, bit for
  bit (as ``tests/test_torch_pipeline.py`` holds ``compress_results=
  True``), within 5e-5 plus one bfloat16 ulp of JAX's compressed fetch:
  the roundings of two values 5e-5 apart may fall on neighbouring
  bfloat16 values, and near zero 5e-5 spans many ulps.
- ``compress_fetch="auto"`` with an injected link profile; the timing
  of the probe dispatches runs on a fake clock (1 ms a reading), since
  what the CPU computes in tens of ms a card computes in a few.
- ``linkprobe``: ``choose_compress`` against JAX's on JAX's cases, and
  ``probe_link`` on the CPU.
- ``vocoder.griffin_lim`` against JAX's on JAX's draws, and
  ``utils.profile_trace``.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechsplit_tpu import convert as jconvert
from speechsplit_tpu import linkprobe as jlinkprobe
from speechsplit_tpu import vocoder as jvocoder
from speechsplit_tpu_torch import convert as tconvert
from speechsplit_tpu_torch import linkprobe, vocoder
from speechsplit_tpu_torch.utils import profile_trace
from tests.jax_interpret import interpret
from tests.test_torch_convert import ATOL, _pairs, models  # noqa: F401

# 3 batches of 1-2 pairs: grids of 7 and 14 rows (JAX's Pallas kernels
# run from 8 rows)
LENGTHS = ([(30, 25)], [(20, 32), (28, 24)], [(16, 22)])
DEPTH = 2
# the auto-mode stream: a first grid of 21 rows x 32 frames, 215 KB of
# float32, whose fetch at the tunnel's 29 MB/s (7.4 ms) is past the
# policy's 5 ms floor
AUTO_LENGTHS = ([(30, 32), (20, 25), (28, 24)], [(16, 22)])
TUNNEL = linkprobe.LinkProfile(f32_mbps=29.0, bf16_mbps=21.0, rtt_ms=10.0)
FAST = linkprobe.LinkProfile(f32_mbps=4000.0, bf16_mbps=3000.0, rtt_ms=0.1)
SLOW_BF16 = linkprobe.LinkProfile(f32_mbps=29.0, bf16_mbps=14.0, rtt_ms=10.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side at these widths is many small ops; with torch's
    intra-op threads contending with other processes for the cores, an
    auto-mode case took 60-68 s in a six-worker run of the suite against
    about 1 s on one thread. One thread changes no value any check
    compares."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(seed=0):
    """Both packages' pair batches: [(jax_pairs, port_pairs), ...]."""
    return [_pairs(lengths, seed=seed + k) for k, lengths in
            enumerate(LENGTHS)]


@pytest.fixture(scope="module")
def jax_stream(models):  # noqa: F811
    """JAX's convert_stream over the batches, once for the module."""
    (jg, g_params, jp, p_params), _ = models
    batches = _batches()
    with pytest.MonkeyPatch.context() as mp:
        interpret(mp)
        want = list(jconvert.convert_stream(
            jg, g_params, jp, p_params, [j for j, _ in batches],
            depth=DEPTH))
    return [p for _, p in batches], want


def _flat(results):
    return [(name, mel) for pair in results for name, mel in pair]


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))


def _assert_rounded_close(got, want, what):
    """Within ATOL plus one bfloat16 ulp of ``want`` (a rounded value)."""
    ref = np.abs(want).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(ref, 1e-30))) - 7)
    assert (np.abs(got - want) <= ATOL + ulp).all(), what


def test_stream_matches_jax_and_convert_batched(models, jax_stream):  # noqa: F811
    _, (g, p) = models
    port_batches, want = jax_stream
    got = list(tconvert.convert_stream(g, p, iter(port_batches),
                                       depth=DEPTH))
    assert len(got) == len(want) == len(LENGTHS)
    # every yield kept to the end of the stream, then compared
    for pairs, yielded, jax_yield in zip(port_batches, got, want):
        batched = _flat(tconvert.convert_batched(g, p, pairs))
        assert [n for n, _ in _flat(yielded)] == [n for n, _ in batched]
        assert [n for n, _ in _flat(yielded)] == [
            n for n, _ in _flat(jax_yield)]
        for (name, mel), (_, same), (_, ref) in zip(
                _flat(yielded), batched, _flat(jax_yield)):
            assert mel.dtype == np.float32
            np.testing.assert_array_equal(mel, same, err_msg=name)
            np.testing.assert_allclose(mel, np.asarray(ref), rtol=0,
                                       atol=ATOL, err_msg=name)


def test_stream_compress_fetch(models, jax_stream):  # noqa: F811
    """Each value is the port's float32 result rounded to bfloat16, and
    within 5e-5 plus one bfloat16 ulp of JAX's compressed fetch (JAX's
    float32 result cast on its device, as its convert_stream does)."""
    _, (g, p) = models
    port_batches, want = jax_stream
    got = list(tconvert.convert_stream(g, p, port_batches,
                                       compress_fetch=True, depth=DEPTH))
    for pairs, yielded, jax_yield in zip(port_batches, got, want):
        exact = _flat(tconvert.convert_batched(g, p, pairs))
        for (name, mel), (_, f32), (_, ref) in zip(
                _flat(yielded), exact, _flat(jax_yield)):
            assert mel.dtype == np.float32
            np.testing.assert_array_equal(mel, _bf16(f32), err_msg=name)
            _assert_rounded_close(mel, _bf16(ref), name)


@pytest.mark.parametrize("depth", [0, 1, DEPTH])
def test_stream_order_and_depth(models, monkeypatch, depth):  # noqa: F811
    """``depth + 1`` submits before the first yield, then one a yield;
    the yields in input order, each equal to its batch's
    ``convert_batched`` after the whole stream (no buffer reuse shows)."""
    _, (g, p) = models
    batches = [pb for _, pb in _batches(seed=10)] + [
        _pairs([(24, 18)], seed=20)[1]]
    batches = [[(s._replace(name=f"b{k}"), t) for s, t in pairs]
               for k, pairs in enumerate(batches)]
    events = []
    submit = tconvert._convert_submit

    def spy(g_model, p_model, pairs, *args, **kwargs):
        events.append(("submit", pairs[0][0].name))
        return submit(g_model, p_model, pairs, *args, **kwargs)

    monkeypatch.setattr(tconvert, "_convert_submit", spy)
    kept = []
    for result in tconvert.convert_stream(g, p, batches, depth=depth):
        events.append(("yield", result[0][0][0].split("_")[0]))
        kept.append(result)
    first = events.index(("yield", batches[0][0][0].name))
    assert [e for e, _ in events[:first]] == ["submit"] * min(
        depth + 1, len(batches))
    assert [n for e, n in events if e == "yield"] == [
        b[0][0].name for b in batches]
    monkeypatch.setattr(tconvert, "_convert_submit", submit)
    for pairs, result in zip(batches, kept):
        for (name, mel), (want_name, want) in zip(
                _flat(result), _flat(tconvert.convert_batched(g, p, pairs))):
            assert name == want_name
            np.testing.assert_array_equal(mel, want, err_msg=name)


@pytest.fixture
def auto(monkeypatch):
    """An empty verdict cache, an injected link profile (counted), and a
    fake clock for the probe dispatches."""
    monkeypatch.setattr(tconvert, "_AUTO_DECISIONS", {})
    probes = []
    profile = {}

    def fake_probe(*args, **kwargs):
        probes.append(args)
        return profile["now"]

    monkeypatch.setattr(linkprobe, "probe_link", fake_probe)
    ticks = iter(range(1_000_000))
    monkeypatch.setattr(tconvert, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks) * 1e-3))
    return profile, probes


@pytest.mark.parametrize("link,chosen", [(TUNNEL, True), (FAST, False)],
                         ids=["tunnel", "fast"])
def test_auto_mode_decides_once_a_key(models, auto, monkeypatch, link,  # noqa: F811
                                      chosen):
    """The tunnel profile fetches bfloat16 and the fast one float32, as
    both packages' ``choose_compress`` decide on the same bytes and
    compute time; the verdict is cached under ``_auto_key``, a second
    stream of that key probes nothing, a different ``cut_max`` decides
    anew, and the yields equal the chosen mode's stream."""
    _, (g, p) = models
    profile, probes = auto
    profile["now"] = link
    batches = [_pairs(lengths, seed=30 + k)[1]
               for k, lengths in enumerate(AUTO_LENGTHS)]
    submits = []
    submit = tconvert._convert_submit

    def spy(*args, **kwargs):
        submits.append(kwargs.get("start_copy", True))
        return submit(*args, **kwargs)

    monkeypatch.setattr(tconvert, "_convert_submit", spy)
    got = list(tconvert.convert_stream(g, p, batches, compress_fetch="auto",
                                       depth=DEPTH))
    key = tconvert._auto_key(batches[0], tconvert.CONDITIONS)
    assert tconvert._AUTO_DECISIONS == {key: chosen}
    # one untimed and two timed probe dispatches, then the batches
    assert submits == [False] * 3 + [True] * len(batches)
    assert len(probes) == 1
    rows = len(batches[0]) * len(tconvert.CONDITIONS)
    grid_bytes = rows * key[2] * 80 * 4
    compute_s = max(1e-3 - link.rtt_ms * 1e-3, 1e-4)  # one clock tick
    jprofile = jlinkprobe.LinkProfile(*link)
    assert jlinkprobe.choose_compress(grid_bytes, compute_s,
                                      jprofile) is chosen
    same = list(tconvert.convert_stream(g, p, batches, compress_fetch=chosen,
                                        depth=DEPTH))
    for a, b in zip(got, same):
        for (name, x), (_, y) in zip(_flat(a), _flat(b)):
            np.testing.assert_array_equal(x, y, err_msg=name)

    # the same key again: no probe, no probe dispatches
    submits.clear()
    list(tconvert.convert_stream(g, p, batches, compress_fetch="auto"))
    assert submits == [True] * len(batches) and len(probes) == 1
    # a shorter fetch (another cut_max) decides anew
    shorter = [_pairs([(12, 10)], seed=7)[1]]
    list(tconvert.convert_stream(g, p, shorter, compress_fetch="auto"))
    assert len(probes) == 2 and len(tconvert._AUTO_DECISIONS) == 2
    assert tconvert._auto_key(shorter[0], tconvert.CONDITIONS) != key


def test_auto_key_and_forced_probe(monkeypatch):
    """``_auto_key`` is JAX's: the R-aware trimmed length; and
    ``probe_link(force=True)`` clears the verdicts, as JAX's does."""
    def pair(ls, lt):
        return (types.SimpleNamespace(length=ls),
                types.SimpleNamespace(length=lt))

    for pairs, conditions in (([pair(64, 80)], tconvert.CONDITIONS),
                              ([pair(190, 192)], tconvert.CONDITIONS),
                              ([pair(64, 192)], ["F"]),
                              ([pair(64, 192), pair(70, 30)], ["R", "U"])):
        assert tconvert._auto_key(pairs, conditions) == jconvert._auto_key(
            pairs, conditions)
    monkeypatch.setattr(linkprobe, "_CACHED", None)
    monkeypatch.setattr(tconvert, "_AUTO_DECISIONS", {(1, 7, 128): True})
    linkprobe.probe_link(size_mb=0.05, force=True, device="cpu")
    assert tconvert._AUTO_DECISIONS == {}
    tconvert._AUTO_DECISIONS[(1, 7, 64)] = False
    tconvert.reset_auto_decisions()
    assert tconvert._AUTO_DECISIONS == {}


GRID = 7 * 192 * 80 * 4  # one pair, 7 conditions, float32 bytes


@pytest.mark.parametrize("link,compute_s,want", [
    (TUNNEL, None, True),      # a slow link, fetch-bound: compress
    (TUNNEL, 1.0, False),      # the same link, compute-bound: don't
    (FAST, None, False),       # a fast link: never (below 5 ms)
    (SLOW_BF16, None, False),  # bfloat16 slower than its bytes: don't
    (TUNNEL, 1e-3, True),      # the fetch outlasts the compute: compress
    (FAST, 1e-6, False),       # the fetch outlasts the compute, but a
                               # fast link's stays below 5 ms
], ids=["tunnel", "tunnel-compute-bound", "fast", "slow-bf16",
        "tunnel-fetch-bound", "fast-tiny-compute"])
def test_choose_compress_policy(link, compute_s, want):
    """JAX's cases (tests/test_convert_batched.py::
    test_choose_compress_policy) and two with a compute estimate below
    the fetch, in both packages."""
    jprofile = jlinkprobe.LinkProfile(*link)
    assert jlinkprobe.choose_compress(GRID, compute_s, jprofile) is want
    assert linkprobe.choose_compress(GRID, compute_s, link) is want


def test_probe_link_on_the_cpu(monkeypatch):
    """Finite, positive rates, cached for the process; with no device
    and no CUDA it refuses, as every entry point does."""
    monkeypatch.setattr(linkprobe, "_CACHED", None)
    profile = linkprobe.probe_link(size_mb=0.05, device="cpu")
    assert all(np.isfinite(v) and v > 0 for v in profile[:2])
    assert np.isfinite(profile.rtt_ms) and profile.rtt_ms >= 0
    assert linkprobe.probe_link(device="cpu") is profile
    monkeypatch.setattr(linkprobe, "_CACHED", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        linkprobe.probe_link()


def test_fetch_on_the_cpu_and_the_ring_checks():
    ring = linkprobe.PinnedRing(2)
    with pytest.raises(ValueError, match="slot"):
        linkprobe.PinnedRing(0)
    assert ring.buffers == [None, None] and ring.turn == 0
    # the CPU has no pinned memory to hand out; the ring is the card's,
    # and a CPU tensor is its own host copy
    x = torch.arange(6.0).reshape(2, 3)
    fetch = linkprobe.start_fetch(x, ring)
    assert fetch.done is None and ring.turn == 0
    np.testing.assert_array_equal(linkprobe.finish_fetch(fetch), x.numpy())
    half = linkprobe.finish_fetch(linkprobe.start_fetch(
        x.to(torch.bfloat16), ring))
    assert half.dtype == np.float32
    np.testing.assert_array_equal(half, x.numpy())


def test_griffin_lim_equals_jax():
    """The bare fast Griffin-Lim on JAX's draws, at the bar
    tests/test_torch_vocoder.py holds mel_griffin_lim to."""
    n_fft, hop, frames = 256, 64, 12
    rng = np.random.RandomState(4)
    mag = rng.uniform(0.0, 1.0, (2, frames, n_fft // 2 + 1)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jvocoder.griffin_lim(jnp.asarray(mag), key,
                                           n_fft=n_fft, hop=hop, n_iter=4))
    draws = np.array(jax.random.uniform(key, mag.shape))
    got = vocoder.griffin_lim(torch.from_numpy(mag),
                              uniform=torch.from_numpy(draws), n_fft=n_fft,
                              hop=hop, n_iter=4)
    assert got.shape == want.shape == (2, (frames - 1) * hop)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="draws"):
        vocoder.griffin_lim(torch.from_numpy(mag), n_fft=n_fft, hop=hop)


def test_profile_trace(tmp_path, monkeypatch):
    """With no directory nothing is written; with one, a TensorBoard
    trace of the region."""
    monkeypatch.chdir(tmp_path)
    x = torch.ones(4, 4)
    with profile_trace(None):
        x @ x
    assert os.listdir(tmp_path) == []
    with profile_trace(str(tmp_path / "trace")):
        x @ x
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
