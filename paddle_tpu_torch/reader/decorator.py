"""Reader decorators — composable ``() -> iterator`` transforms.

The counterpart of paddle_tpu/reader/decorator.py. Mirrors the API
surface of Paddle's python/paddle/v2/reader/decorator.py:29-337 (map_readers,
shuffle, chain, compose, buffered, firstn, xmap_readers) with the same
contract: a *reader* is a zero-arg callable returning a fresh iterator over
samples; a *reader creator/decorator* builds readers from readers. This
composability is what lets datasets, augmentation, shuffling and batching
stack without touching the training loop.

Implementation is original (py3 threads/queues; the reference is py2
Queue/itertools.imap); ``cache`` is an extension used by benchmarks to
freeze a finite reader's output in memory.
"""

from __future__ import annotations

import itertools
import random
import threading
import queue as _queue


def map_readers(func, *readers):
    """Reader yielding ``func(*samples)`` drawn in lockstep from ``readers``
    (decorator.py:29)."""

    def reader():
        its = [r() for r in readers]
        for args in zip(*its):
            yield func(*args)

    return reader


def shuffle(reader, buf_size, pool=None):
    """Buffered shuffling (decorator.py:52): fill a ``buf_size`` buffer,
    shuffle it, emit, repeat. The classic streaming-shuffle compromise.
    With ``pool`` (a reader.pool.WorkerPool) the buffer fill+shuffle runs
    on a pool-bookkept staging thread, decoupled from the consumer."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    if pool is not None:
        return pool.background(data_reader, capacity=2)
    return data_reader


def chain(*readers):
    """Concatenate readers' outputs in sequence (decorator.py:82)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into tuple samples (decorator.py:110): outputs
    (r1_sample, *r2_sample...) flattened one level. check_alignment=True
    (default) raises ComposeNotAligned when readers end at different
    lengths."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        its = [r() for r in readers]
        if check_alignment:
            for outputs in itertools.zip_longest(*its):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            for outputs in zip(*its):
                yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size):
    """Decouple producer and consumer with a bounded queue filled by a
    background thread (decorator.py:160) — host-side pipelining."""

    class _End:
        pass

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)

        def feed():
            try:
                for d in r:
                    q.put(d)
            finally:
                q.put(_End)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return data_reader


def firstn(reader, n):
    """First ``n`` samples only (decorator.py:191)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with ``process_num`` worker threads
    (decorator.py:211 XmapEndSignal machinery). ``order=True`` preserves
    input order via sequence numbers. A spelling of ``pool.pool_map``,
    which replaces the reference's hang-on-error queue machinery with loud
    worker-error propagation and leak-free shutdown."""
    from .pool import pool_map
    return pool_map(mapper, reader, process_num, ordered=order,
                    capacity=buffer_size)


def cache(reader):
    """Materialize a finite reader once and replay from memory afterwards
    (an extension — used to amortize host decode in benchmarks)."""
    memo = []
    filled = [False]

    def cached_reader():
        if filled[0]:
            yield from memo
            return
        for s in reader():
            memo.append(s)
            yield s
        filled[0] = True

    return cached_reader


def bucket_by_length(reader, key, bucket_bounds, batch_size, drop_last=False):
    """Group samples into length buckets and emit per-bucket batches — the
    feed-side answer to Paddle's batch-shrinking RNN machinery
    (operators/lod_rank_table_op.cc + shrink_rnn_memory_op.cc: sort by
    length, retire finished sequences each step). A padded batch runs
    recurrent steps up to its padded length, so batching sequences of
    similar length makes each batch run ~ITS OWN max length, not the
    corpus max — and the bucket bounds cap the set of distinct padded
    shapes (pad each batch to its bucket's bound).

    Args:
        reader: sample reader.
        key: sample -> int length (e.g. ``lambda s: len(s[0])``).
        bucket_bounds: ascending upper bounds; a final unbounded bucket
            catches the tail (longer sequences).
        batch_size: samples per emitted batch.
        drop_last: drop per-bucket remainders at exhaustion.

    Returns a reader over plain batches (lists of samples), like
    paddle.batch; the pad target for a batch is
    ``bucket_bound_for(bucket_bounds, max(key(s) for s in batch))``.
    """
    bounds = sorted(int(b) for b in bucket_bounds)

    def which(n):
        for i, b in enumerate(bounds):
            if n <= b:
                return i
        return len(bounds)

    def bucketed_reader():
        buckets = [[] for _ in range(len(bounds) + 1)]
        for sample in reader():
            b = buckets[which(key(sample))]
            b.append(sample)
            if len(b) == batch_size:
                yield list(b)
                del b[:]
        if not drop_last:
            for b in buckets:
                if b:
                    yield list(b)

    return bucketed_reader


def bucket_bound_for(bucket_bounds, length):
    """The padded length a batch of max sample length ``length`` compiles at
    (the companion of bucket_by_length: feed-side pad target)."""
    for b in sorted(int(x) for x in bucket_bounds):
        if length <= b:
            return b
    return length
