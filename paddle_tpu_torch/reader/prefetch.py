"""Host→device double-buffer prefetch (counterpart of
paddle_tpu/reader/prefetch.py).

Paddle's paddle/fluid/operators/reader/create_double_buffer_reader_op.cc:
25-68 keeps a background thread pulling batches from the decorated reader
and staging them into a small pool of device-side buffers ahead of the
consumer. Here a ``DeviceFeedIterator`` wraps a batched feed-dict reader;
a daemon thread converts each batch (a user ``convert`` fn, e.g. a
DataFeeder's ``feed``), pins its host tensors, copies them to the card
with ``non_blocking=True`` on a CUDA stream of its own, applies ``cast``
there (e.g. images to bf16 for AMP), records an event, and parks the batch
in a bounded queue. When the training loop takes a batch, its current
stream waits on that event and every staged tensor is ``record_stream``-ed
onto it, so no kernel reads a tensor before its copy lands and the caching
allocator does not hand the memory to a later batch while the consumer's
stream still reads it. The host-to-device copy of batch n+1 so overlaps
the compute of batch n. On a CPU place the batch becomes CPU tensors (no
stream, no copy of a numpy array's memory).
"""

from __future__ import annotations

import queue as _queue
import threading

import numpy as np
import torch

from ..core.lod import LoDArray

# batches (and their bytes) staged onto a card since the last reset: what
# the double buffer copied, which the tests and chip_smoke.py read
staged = {"batches": 0, "bytes": 0}
_STAGED_LOCK = threading.Lock()


def reset_staged():
    with _STAGED_LOCK:
        staged.update(batches=0, bytes=0)


def background_buffer(reader, capacity=2, stage=None, register=None):
    """Record-agnostic bounded background prefetch: returns a creator whose
    iterator is fed by a daemon thread (``stage`` runs per item IN the
    feeder, e.g. the copy to the card). BaseException-safe: the end
    sentinel is enqueued in a finally so the consumer can never hang,
    feeder errors re-raise consumer-side, and abandoning the iterator
    mid-pass releases the feeder (stop flag polled on every bounded put).
    ``register`` is called with ``(thread, stop_event)`` before each
    feeder starts (WorkerPool.background uses it to bookkeep stagers and
    cancel/join them at shutdown). One implementation for the feed-dict
    (DeviceFeedIterator), slot-tuple (reader-graph op), and pool-staging
    flavors."""

    def make():
        q = _queue.Queue(maxsize=max(1, int(capacity)))
        end, err = object(), []
        stop = threading.Event()

        def put(item):
            # bounded put that notices an abandoned consumer: without the
            # stop check a `break` out of the consuming loop would leave the
            # feeder blocked forever on the full queue, pinning its staged
            # (device-resident) batches and the open readers
            while True:
                try:
                    q.put(item, timeout=0.05)
                    return True
                except _queue.Full:
                    if stop.is_set():
                        return False

        def feed():
            try:
                for item in reader():
                    if not put(stage(item) if stage is not None else item) \
                            or stop.is_set():
                        return
            except BaseException as e:   # surface in consumer
                err.append(e)
            finally:
                put(end)

        t = threading.Thread(target=feed, daemon=True)
        if register is not None:
            register(t, stop)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.05)
                except _queue.Empty:
                    if stop.is_set():
                        # cancelled externally (pool shutdown): the feeder
                        # is gone and may not have managed to enqueue the
                        # end sentinel — fail loudly instead of hanging
                        raise RuntimeError(
                            "background reader cancelled mid-stream")
                    continue
                if item is end:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()

    return make


def resolve_place(place):
    """The torch.device a place names (``None``: ``CUDAPlace(0)``, which
    raises where there is no card); a place may also be a torch.device or
    the ``str`` of a place, as a reader op's ``place`` attr holds it
    ("CPUPlace", "CUDAPlace(1)")."""
    from ..core.executor import resolve_device
    if isinstance(place, torch.device):
        return place
    if isinstance(place, str):
        text = place.strip()
        if "CPU" in text.upper():
            return torch.device("cpu")
        if text.startswith("CUDAPlace(") and text.endswith(")"):
            from ..core.executor import CUDAPlace
            return resolve_device(CUDAPlace(int(text[10:-1] or 0)))
        raise ValueError(f"unknown place {place!r}")
    return resolve_device(place)


class _Staged:
    """A batch copied on the feeder's stream, and the event its copies
    end at."""

    __slots__ = ("item", "event", "tensors")

    def __init__(self, item, event, tensors):
        self.item = item
        self.event = event
        self.tensors = tensors


class DeviceStager:
    """Moves batches onto ``device``: ``stage`` in the feeder thread,
    ``hand_over`` in the consumer's. A batch is a dict (a feed dict), a
    tuple or list (a reader op's slots), a LoDArray (its data, lens and
    outer levels go together), an array, a tensor or a scalar; a dict's
    ``cast`` entries (name -> torch dtype) are cast on the device."""

    def __init__(self, device, cast=None):
        self.device = device
        self.cast = {k: _torch_dtype(v) for k, v in dict(cast or {}).items()}
        self._stream = None

    def stage(self, batch):
        if self.device.type != "cuda":
            return self._move(batch, [])
        torch.cuda.set_device(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        tensors = []
        with torch.cuda.stream(self._stream):
            item = self._move(batch, tensors)
            event = torch.cuda.Event()
            event.record(self._stream)
        with _STAGED_LOCK:
            staged["batches"] += 1
            staged["bytes"] += sum(t.numel() * t.element_size()
                                   for t in tensors)
        return _Staged(item, event, tensors)

    def hand_over(self, batch):
        """The staged batch, safe to use on the caller's current stream."""
        if not isinstance(batch, _Staged):
            return batch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(batch.event)
        for t in batch.tensors:
            t.record_stream(stream)
        return batch.item

    def _move(self, value, tensors, name=None):
        if isinstance(value, dict):
            return {k: self._move(v, tensors, k) for k, v in value.items()}
        if isinstance(value, (tuple, list)):
            return tuple(self._move(v, tensors) for v in value)
        if isinstance(value, LoDArray):
            return LoDArray(
                self._leaf(value.data, tensors, name),
                self._leaf(value.lens, tensors),
                tuple(self._leaf(o, tensors)
                      for o in value.outer_levels) or None)
        if isinstance(value, (str, bytes)):
            return value
        return self._leaf(value, tensors, name)

    def _leaf(self, value, tensors, name=None):
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        if self.device.type == "cuda":
            if t.device.type == "cpu":
                # pageable memory makes a non_blocking copy synchronous;
                # pin_memory() draws on the caching host allocator
                t = t.pin_memory()
            t = t.to(self.device, non_blocking=True)
        elif t.device != self.device:
            t = t.to(self.device)
        dt = self.cast.get(name) if name is not None else None
        if dt is not None:
            t = t.to(dt)
        tensors.append(t)
        return t


def _torch_dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    from ..core.types import torch_dtype
    return torch_dtype(str(dt))


def device_buffer(reader, place=None, capacity=2, convert=None, cast=None):
    """A creator over ``reader``'s items staged onto ``place``'s device by
    a background thread (:class:`DeviceStager`), ``capacity`` batches
    ahead; ``convert`` runs on each item in that thread first."""
    device = resolve_place(place)

    def make():
        stager = DeviceStager(device, cast)

        def stage(item):
            return stager.stage(convert(item) if convert is not None
                                else item)

        it = background_buffer(reader, capacity, stage)()
        try:
            for batch in it:
                yield stager.hand_over(batch)
        finally:
            it.close()

    return make


def double_buffer(reader, place=None, capacity=2, convert=None):
    """Decorate a feed-dict reader so its batches arrive device-resident.
    Returns a reader (zero-arg callable) like every other decorator."""

    def data_reader():
        return iter(DeviceFeedIterator(reader, place=place,
                                       capacity=capacity, convert=convert))

    return data_reader


class DeviceFeedIterator:
    """Iterates device-staged feed dicts produced by a background thread.
    ``place=None`` means ``CUDAPlace(0)``; ``CPUPlace()`` gives CPU
    tensors."""

    def __init__(self, reader, place=None, capacity=2, convert=None,
                 cast=None):
        self._make = device_buffer(reader, place, capacity, convert, cast)

    def __iter__(self):
        return self._make()
