"""Background host->device prefetch (counterpart of
speechsplit_tpu/data/prefetch.py: ``stack_batches`` :22 and
``prefetch_to_device``).

The reference copies four tensors to the GPU synchronously inside its
hot loop (solver.py:147-150). Here a background thread turns each numpy
``Batch`` into tensors and, on CUDA, copies them from pinned host memory
with ``non_blocking=True`` on a side stream, so the next batches are on
the card before the step asks for them. The consumer's stream waits on
an event recorded after each batch's copies, and every tensor is marked
used on the consumer's stream (``record_stream``): without that the
caching allocator, which sees the tensor as the side stream's, could
hand its memory to the next copy while the step still reads it. Any
named tuple of arrays travels: a ``Batch``, a stacked ``[k, ...]`` batch
(:func:`stack_batches`) or a crop plan of the device-resident path
(``data.resident.Plan``).

An exception raised by the source iterator (or by the transfer) is
re-raised by the consumer at the batch it stopped; the JAX package's
worker ends the stream there instead.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterator, NamedTuple, TypeVar

import numpy as np
import torch

from speechsplit_tpu_torch import resolve_device

T = TypeVar("T", bound=tuple)


class _Failed(NamedTuple):
    error: BaseException


_DONE = object()


def stack_batches(iterator: Iterator[T], k: int) -> Iterator[T]:
    """Group k host batches into one with a leading ``[k]`` axis on every
    field (JAX prefetch.py:22), for ``make_train_multi_step``: one
    transfer and one call then advance the model k steps. A trailing
    group smaller than k is dropped (the training sampler never ends).
    Works on any named tuple of arrays (``Batch``, ``Plan``)."""
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    group = []
    for batch in iterator:
        group.append(batch)
        if len(group) == k:
            yield type(batch)(*(np.stack(xs) for xs in zip(*group)))
            group = []


def _to_tensor(x, compress: bool) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x))
    if compress and t.dtype == torch.float32:
        return t.to(torch.bfloat16)
    return t


def prefetch_to_device(
    iterator: Iterator[T],
    *,
    size: int = 2,
    device=None,
    compress: bool = False,
) -> Iterator[T]:
    """Wrap a host batch iterator with background transfer to ``device``
    (``cuda`` unless told otherwise); yields each item rebuilt as its own
    named tuple of tensors there, in the source's order, at most ``size``
    ahead of the consumer.

    ``compress=True`` sends float32 features as ``torch.bfloat16`` (half
    the bytes; the train step's ``_upcast_batch`` casts them back, at
    about 4e-3 quantization of [0, 1] mels). Integer arrays are sent as
    they are. The thread starts at once; the returned iterator's
    ``close()`` stops it.
    """
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    buf: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def transfer(batch: T):
        host = [_to_tensor(x, compress) for x in batch]
        if not cuda:
            return type(batch)(*host), None
        with torch.cuda.stream(copy_stream):
            moved = [t.pin_memory().to(dev, non_blocking=True) for t in host]
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return type(batch)(*moved), ready

    def worker():
        try:
            with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
                for batch in iterator:
                    if not offer(transfer(batch)):
                        return
        except BaseException as error:  # the consumer re-raises it
            offer(_Failed(error))
            return
        offer(_DONE)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    return _Prefetched(buf, stop, thread, dev)


class _Prefetched:
    """The consumer's end: an iterator of batches ready on its stream."""

    def __init__(self, buf: "queue.Queue", stop: threading.Event,
                 thread: threading.Thread, dev: torch.device):
        self._buf, self._stop, self._thread, self._dev = (
            buf, stop, thread, dev)
        self._ended = False

    def __iter__(self) -> "_Prefetched":
        return self

    def __next__(self) -> tuple:
        if self._ended:
            raise StopIteration
        item = self._buf.get()
        if item is _DONE or isinstance(item, _Failed):
            self._ended = True
            self.close()
            if item is _DONE:
                raise StopIteration
            raise item.error
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._dev)
            stream.wait_event(ready)
            for t in batch:
                t.record_stream(stream)
        return batch

    def close(self) -> None:
        """Stop the thread (it drops what it has not handed over)."""
        self._ended = True
        self._stop.set()
        self._thread.join()
