"""Device-to-host link probing for adaptive fetch policies (counterpart of
speechsplit_tpu/linkprobe.py), and the pinned copy that conversion
fetches its results through.

Whether a conversion grid is worth rounding to bfloat16 before it
crosses to the host depends on the link: behind a slow link the fetch
dominates a stream and halving its bytes pays; on a card in the same
host (an H100 on PCIe or NVLink-C2C moves GB/s) fetching float32 costs
less than the rounding. :func:`probe_link` measures the link once per
process and :func:`choose_compress` turns a grid's size (and, where the
caller has it, its compute time) into the choice; ``convert_stream``'s
``compress_fetch="auto"`` and ``VoiceConverter``'s
``compress_results="auto"`` decide through them.

The probe's timed fetch is the one conversion uses: the result is copied
on a copy stream into a pinned host buffer (:func:`start_fetch`), and
the caller waits for it and copies it out into a fresh array of its own
(:func:`finish_fetch`). Methodology (JAX linkprobe.py:14-22):
- fetch FRESH outputs (a new ``torch.rand`` draw each time), so no host
  copy of an earlier fetch is read;
- subtract the round-trip latency of a scalar fetch, so the rate is the
  link's bandwidth, not its latency;
- a warm fetch comes first, and the dtypes are interleaved, the best of
  two kept for each.
"""

from __future__ import annotations

import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from speechsplit_tpu_torch import resolve_device


class LinkProfile(NamedTuple):
    f32_mbps: float
    bf16_mbps: float
    rtt_ms: float


_CACHED: Optional[LinkProfile] = None
_COPY_STREAMS: dict = {}


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's copy stream (one a process), beside its compute
    stream."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _COPY_STREAMS:
        _COPY_STREAMS[index] = torch.cuda.Stream(device=index)
    return _COPY_STREAMS[index]


class PinnedRing:
    """``slots`` pinned host buffers, handed out in turn.

    A stream that keeps at most ``slots`` fetches in flight, and finishes
    them in the order it started them, never writes a buffer that an
    unfinished fetch still reads from: the slot comes round again only
    after ``slots`` later starts. A slot is a flat byte buffer that grows
    to the largest result it has held, so a stream whose grids vary in
    length keeps ``slots`` buffers, not one a shape."""

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"a ring needs at least one slot, got {slots}")
        self.buffers: List[Optional[torch.Tensor]] = [None] * slots
        self.turn = 0

    def reserve(self, nbytes: int) -> None:
        """Allocate every slot at ``nbytes`` now, so that no timed fetch
        pays for a pinned allocation."""
        for i, buf in enumerate(self.buffers):
            if buf is None or buf.numel() < nbytes:
                self.buffers[i] = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=True)

    def take(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """The next slot, viewed as a contiguous ``shape`` of ``dtype``."""
        count = int(np.prod(shape))
        nbytes = count * torch.empty((), dtype=dtype).element_size()
        i = self.turn % len(self.buffers)
        self.turn += 1
        buf = self.buffers[i]
        if buf is None or buf.numel() < nbytes:
            buf = self.buffers[i] = torch.empty(nbytes, dtype=torch.uint8,
                                                pin_memory=True)
        return buf[:nbytes].view(dtype).view(shape)


class Fetch(NamedTuple):
    """A device-to-host copy in flight: ``host`` is the pinned buffer it
    writes (the tensor itself on the CPU) and ``done`` the event the copy
    stream records after it (None on the CPU)."""

    host: torch.Tensor
    done: Optional["torch.cuda.Event"]


def start_fetch(x: torch.Tensor, ring: PinnedRing) -> Fetch:
    """Start copying ``x`` to the host without waiting for it.

    On CUDA the copy stream waits for an event recorded on the current
    (compute) stream, copies ``x`` into the ring's next pinned buffer
    with ``non_blocking=True`` and records ``done``; ``x`` is marked as
    used on the copy stream, so its memory is not reused under the copy.
    On the CPU there is no link to cross: the tensor is its own host
    copy."""
    if not x.is_cuda:
        return Fetch(x, None)
    x = x.contiguous()
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(x.device))
    stream = _copy_stream(x.device)
    host = ring.take(tuple(x.shape), x.dtype)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host.copy_(x, non_blocking=True)
        x.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
    return Fetch(host, done)


def finish_fetch(fetch: Fetch) -> np.ndarray:
    """Wait for the copy and return it as a fresh float32 array: the
    pinned buffer goes back to its ring, so nothing returned aliases it
    (a bfloat16 result is widened by that same copy). The copy-out is a
    torch copy, which splits a large tensor across the host's threads
    (a 314 MB grid: PERF.md §6, PR 21)."""
    if fetch.done is not None:
        fetch.done.synchronize()
    host = fetch.host
    if host.dtype != torch.float32:
        return host.float().numpy()
    if fetch.done is None:
        return host.numpy()
    out = torch.empty(host.shape, dtype=torch.float32)
    out.copy_(host)
    return out.numpy()


def probe_link(size_mb: float = 2.0, force: bool = False,
               device=None) -> LinkProfile:
    """Measure fetch bandwidth per dtype and the RTT; cached per process.

    ``force=True`` measures again and drops every decision taken on the
    old profile (``convert``'s ``compress_fetch="auto"`` cache), as JAX
    linkprobe.py:43-59 does. ``device`` defaults to ``cuda``; the CPU is
    probed only when asked for (its "link" is a host copy)."""
    global _CACHED
    if _CACHED is not None and not force:
        return _CACHED
    if force:
        # through sys.modules: convert imports this module
        conv = sys.modules.get("speechsplit_tpu_torch.convert")
        if conv is not None:
            conv.reset_auto_decisions()
    dev = resolve_device(device)
    n = int(size_mb * 1e6 / 4)
    gen = torch.Generator(device=dev)
    ring = PinnedRing(1)
    if dev.type == "cuda":
        ring.reserve(n * 4)

    def fresh(seed: int, dtype: torch.dtype) -> torch.Tensor:
        gen.manual_seed(seed)
        x = torch.rand(n, generator=gen, device=dev)
        return (x + 1.0).to(dtype)

    def fetch(x: torch.Tensor) -> np.ndarray:
        return finish_fetch(start_fetch(x, ring))

    fetch(fresh(0, torch.float32)[:8])  # warm the copy path

    def rtt() -> float:
        t0 = time.perf_counter()
        float(torch.ones((), device=dev) + 1.0)
        return time.perf_counter() - t0

    rtt_s = min(rtt(), rtt())

    def rate(dtype: torch.dtype, nbytes_per_elem: int, seed: int) -> float:
        out = fresh(seed, dtype)  # fresh output: no earlier host copy
        t0 = time.perf_counter()
        fetch(out)
        dt = max(time.perf_counter() - t0 - rtt_s, 1e-6)
        return n * nbytes_per_elem / dt / 1e6

    # interleave dtypes (drift protection) and keep the best of two
    f32 = rate(torch.float32, 4, 1)
    b16 = rate(torch.bfloat16, 2, 2)
    f32 = max(f32, rate(torch.float32, 4, 3))
    b16 = max(b16, rate(torch.bfloat16, 2, 4))
    _CACHED = LinkProfile(round(f32, 2), round(b16, 2), round(rtt_s * 1e3, 2))
    return _CACHED


def choose_compress(
    bytes_f32: int,
    compute_s: Optional[float] = None,
    profile: Optional[LinkProfile] = None,
) -> bool:
    """Should a result of ``bytes_f32`` be fetched as bfloat16?

    bfloat16 wins when the float32 fetch takes longer than BOTH the
    bfloat16 fetch and, when the caller can estimate it, the overlapped
    device compute: on a compute-bound stream the cast and the slower
    bfloat16 rate are pure cost. On a fast local link float32 wins
    outright (JAX linkprobe.py:97-123, line for line)."""
    p = profile or probe_link()
    t_f32 = bytes_f32 / (p.f32_mbps * 1e6)
    t_b16 = (bytes_f32 / 2) / (p.bf16_mbps * 1e6)
    if t_b16 >= t_f32:
        return False
    if compute_s is not None and t_f32 <= compute_s:
        return False  # compute-bound: compression cannot raise throughput
    # no compute estimate: compress only when the fetch is slow enough
    # to plausibly dominate (tunnel-class links; more than 5 ms a result)
    return t_f32 > 5e-3
