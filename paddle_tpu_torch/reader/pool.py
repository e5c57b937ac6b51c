"""Shared bounded worker pool for host-side record decode/transform
(counterpart of paddle_tpu/reader/pool.py).

Paddle keeps the accelerator fed with a C++ multi-threaded prefetch pool
(paddle/fluid/operators/reader/create_double_buffer_reader_op.cc and
open_files' ``thread_num``). Here the
same role is a pool of Python threads running GIL-releasing decode work
(zlib inflate, numpy bulk ops, file I/O): ``WorkerPool.imap`` maps a
per-record function over a stream across ``thread_num`` workers, in
order-preserving or unordered mode, and several streams can share one pool
— ``open_files`` runs the decode of all its file shards through a single
pool.

Discipline (shared with reader/prefetch.background_buffer):

* BaseException-safe error propagation — a worker or feeder error travels
  to the consumer and re-raises there; nothing can hang waiting for a
  result that will never come.
* Clean shutdown — abandoning a consumer iterator mid-stream (``close()``
  / ``GeneratorExit`` / an exception in the consuming loop) cancels the
  stream, unblocking its feeder and releasing its workers back to the
  pool; :meth:`WorkerPool.shutdown` then joins every thread, so tests can
  assert no threads leak.
* Bounded buffering — at most ``capacity`` records are in flight per
  stream (submitted but not yet yielded), so a fast producer can never
  balloon host memory.
"""

from __future__ import annotations

import queue as _queue
import threading

__all__ = ["WorkerPool", "pool_map", "interleave"]

# polling granularity for interruptible queue waits; every blocking wait in
# this module re-checks its stream's stop flag at this period, which is what
# makes shutdown deadlock-free without a wake-up token per waiter
_TICK = 0.05


class _Stream:
    """Per-imap bookkeeping shared between feeder, workers and consumer."""

    __slots__ = ("out", "slots", "stop", "error", "total", "done_feeding")

    def __init__(self, capacity):
        # out is unbounded: in-flight items are already bounded by ``slots``
        self.out = _queue.Queue()
        self.slots = threading.BoundedSemaphore(capacity)
        self.stop = threading.Event()
        self.error = []
        self.total = None            # set by the feeder when input ends
        self.done_feeding = threading.Event()


class WorkerPool:
    """``thread_num`` daemon workers pulling tasks off one shared queue.

    Tasks come from :meth:`imap` (parallel per-record map) and
    :meth:`background` (stage a whole reader through a bounded queue).
    Multiple streams interleave on the same workers, so one pool serves a
    whole reader chain (decode + shuffle staging + batch staging).
    """

    def __init__(self, thread_num, capacity=None):
        self.thread_num = max(1, int(thread_num))
        # default per-stream in-flight bound: enough to keep every worker
        # busy plus a reorder margin for ordered mode
        self.capacity = max(self.thread_num,
                            int(capacity or 2 * self.thread_num))
        self._tasks = _queue.Queue()
        self._closed = False
        self._streams = []           # live imap streams, cancelled on shutdown
        self._aux_threads = []       # background() stagers, joined on shutdown
        self._workers = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"reader-pool-{i}")
            for i in range(self.thread_num)]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------------
    def _work(self):
        while True:
            task = self._tasks.get()
            if task is None:         # poison pill from shutdown()
                return
            task()

    # ------------------------------------------------------------------
    def imap(self, fn, iterable, ordered=True, capacity=None):
        """Iterator of ``fn(item)`` computed across the pool's workers.

        ``ordered=True`` preserves input order (results buffer until their
        predecessors arrive); ``ordered=False`` yields completion order.
        Either way every input item is mapped exactly once. Errors raised
        by ``fn`` (or by iterating ``iterable``) re-raise here; a shutdown()
        racing an active stream cancels it with a loud RuntimeError rather
        than hanging or silently truncating.
        """
        if self._closed:
            raise RuntimeError("imap on a shut-down WorkerPool")
        stream = _Stream(max(1, int(capacity or self.capacity)))
        self._streams = [s for s in self._streams if not s.stop.is_set()]
        self._streams.append(stream)

        def submit(i, item):
            def task():
                if stream.stop.is_set():
                    return
                try:
                    stream.out.put((i, fn(item)))
                except BaseException as e:
                    stream.error.append(e)
                    stream.stop.set()
            self._tasks.put(task)

        def feed():
            n = 0
            try:
                for item in iterable:
                    while not stream.slots.acquire(timeout=_TICK):
                        if stream.stop.is_set():
                            return
                    if stream.stop.is_set():
                        return
                    submit(n, item)
                    n += 1
            except BaseException as e:
                stream.error.append(e)
                stream.stop.set()
            finally:
                stream.total = n
                stream.done_feeding.set()

        feeder = threading.Thread(target=feed, daemon=True,
                                  name="reader-pool-feeder")
        feeder.start()

        def consume():
            received = 0
            pending, next_idx = {}, 0
            try:
                while True:
                    if stream.error:
                        raise stream.error[0]
                    if stream.stop.is_set():
                        # externally cancelled (pool shutdown mid-stream).
                        # Checked BEFORE the completion test: a cancelled
                        # feeder stops submitting and still sets
                        # done_feeding, so completion could otherwise look
                        # normal and silently truncate — fail loudly
                        # instead. (Normal completion never sets stop: only
                        # errors, shutdown, and this generator's own exit
                        # do.)
                        raise RuntimeError(
                            "WorkerPool shut down during iteration")
                    if stream.done_feeding.is_set() \
                            and received >= stream.total:
                        return
                    try:
                        i, res = stream.out.get(timeout=_TICK)
                    except _queue.Empty:
                        continue
                    received += 1
                    if not ordered:
                        stream.slots.release()
                        yield res
                        continue
                    pending[i] = res
                    while next_idx in pending:
                        stream.slots.release()
                        yield pending.pop(next_idx)
                        next_idx += 1
            finally:
                stream.stop.set()
                feeder.join()

        return consume()

    # ------------------------------------------------------------------
    def _register_stage_thread(self, t, stop):
        t.name = "reader-pool-stage"
        # prune finished stagers so a long-lived pool driving many epochs
        # doesn't accumulate dead Thread objects
        self._aux_threads = [(a, s) for a, s in self._aux_threads
                             if a.is_alive()]
        self._aux_threads.append((t, stop))

    def background(self, reader, capacity=2):
        """Decorate ``reader`` so its items are produced by a staging
        thread bookkept by this pool (joined at :meth:`shutdown`), with a
        bounded hand-off queue — prefetch.background_buffer with pool
        bookkeeping. The stager is a dedicated thread rather than a pool
        task on purpose: a stream-lifetime task would pin a worker, and a
        chain like ``imap(decode) -> background(batch)`` on a 1-thread
        pool would deadlock.
        """
        from .prefetch import background_buffer
        return background_buffer(reader, capacity,
                                 register=self._register_stage_thread)

    # ------------------------------------------------------------------
    def shutdown(self, timeout=5.0):
        """Stop every worker and join all pool threads. Idempotent; safe
        while streams are mid-flight: their stop flags are set, so feeders
        unblock and consumers raise RuntimeError instead of hanging on
        tasks that will never run."""
        if not self._closed:
            self._closed = True
            for s in self._streams:
                s.stop.set()
            self._streams = []
            for _, stop in self._aux_threads:
                stop.set()
            for _ in self._workers:
                self._tasks.put(None)
        for t in self._workers + [a for a, _ in self._aux_threads]:
            t.join(timeout)

    def live_threads(self):
        """Names of pool-owned threads still alive (test hook)."""
        return [t.name for t in
                self._workers + [a for a, _ in self._aux_threads]
                if t.is_alive()]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def pool_map(mapper, reader, thread_num, ordered=True, capacity=None,
             pool=None):
    """Reader decorator: ``mapper`` over samples across ``thread_num``
    threads — the pooled successor of ``decorator.xmap_readers`` (same
    contract, shared-pool execution, loud error propagation). With
    ``pool`` given, its workers are used (and it stays open); otherwise a
    transient pool lives for exactly one iteration.
    """

    def data_reader():
        own = pool or WorkerPool(thread_num, capacity)
        try:
            yield from own.imap(mapper, reader(), ordered=ordered,
                                capacity=capacity)
        finally:
            if own is not pool:
                own.shutdown()

    return data_reader


def interleave(readers, max_open=None):
    """One reader round-robining over ``readers`` (one per file shard) —
    the host-side form of the reference open_files' multi-file interleave.
    Every record of every shard is yielded exactly once. ``max_open``
    bounds how many shard iterators are live at once (an exhausted shard's
    slot goes to the next pending one), so a thousand-file open_files
    holds ``max_open`` file descriptors, not a thousand; default: all."""
    readers = list(readers)
    cap = len(readers) if max_open is None else max(1, int(max_open))

    def data_reader():
        pending = iter(readers)
        active = [iter(r()) for _, r in zip(range(cap), pending)]
        while active:
            alive = []
            for it in active:
                try:
                    item = next(it)
                except StopIteration:
                    nxt = next(pending, None)
                    if nxt is not None:
                        alive.append(iter(nxt()))  # joins next round
                    continue
                alive.append(it)
                yield item
            active = alive

    return data_reader
