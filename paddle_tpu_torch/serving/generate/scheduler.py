"""ContinuousBatcher: step-boundary scheduling of generation requests
(counterpart of paddle_tpu/serving/generate/scheduler.py).

Sequences JOIN the running batch at any step boundary (a queued prompt is
prefilled the moment a slot and enough KV blocks free up) and LEAVE the
moment they hit EOS or their token budget: the batch never waits for its
slowest member. ``continuous=False`` keeps gang scheduling (admit a full
batch, run it to completion, admit the next) as the baseline to compare
against.

Backpressure: a bounded wait queue that rejects fast with the typed
:class:`~..batcher.ServerOverloaded` when full. Admission is strict FIFO:
a head request that does not fit (slots or blocks) blocks the queue
rather than being overtaken, so admission order, and with it every token
stream, is deterministic. Under chunked prefill a long prompt admits at
once and its prefill interleaves with decode: each worker turn is one
``engine.step()``, which runs at most one bounded prefill chunk before the
decode dispatch.

``submit`` returns a :class:`TokenStream`, an iterator the caller drains as
the worker emits tokens. Closing a stream early cancels its sequence: the
worker aborts it at the next step boundary and its slot and blocks
recycle.

Per-request telemetry as the reference records it (:218-258): TTFT is
submit to the first actual token, stamped once into ``engine.ttft`` (a
request that ends before its first token discards its probe and is
counted); TPOT, the mean time per token after the first, is recorded once
at stream end into ``engine.tpot`` for streams of at least 2 tokens. The
reference's obs.metrics counters and flight-recorder events are plain
counters here.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque

from ...core.flags import get_flag
from ..batcher import ServerOverloaded
from .decode_engine import CacheExhausted, NoFreeSlots, normalize_sampling


class _Cancelled(Exception):
    pass


class TokenStream:
    """Iterator over one request's generated token ids. ``close()``
    cancels the request; worker-side errors re-raise in the consumer."""

    _DONE = object()

    def __init__(self, batcher):
        self._batcher = batcher
        self._q = queue.Queue()
        self._closed = False
        self.first_token_s = None      # set by the worker (TTFT probe)
        self._submit_s = None          # the worker stamps TTFT against it
        self._first_emit_t = None
        self._last_emit_t = None
        self._ntokens = 0
        self._resolved = False         # TTFT probe stamped or discarded
        self._tpot_done = False

    # worker side -------------------------------------------------------
    def _emit(self, tokens):
        for t in tokens:
            self._q.put(int(t))

    def _finish(self, error=None):
        self._q.put(error if error is not None else self._DONE)

    # consumer side -----------------------------------------------------
    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        if not self._closed:
            self._closed = True
            self._batcher._cancel(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _Pending:
    __slots__ = ("prompt", "max_new", "sampling", "stream", "submit_s")

    def __init__(self, prompt, max_new, sampling, stream, submit_s):
        self.prompt = prompt
        self.max_new = max_new
        self.sampling = sampling
        self.stream = stream
        self.submit_s = submit_s


class ContinuousBatcher:
    """Drives a :class:`~.decode_engine.GenerationEngine` from one worker
    thread: admit (continuous: whenever capacity frees; gang: only when
    the batch drained), one engine step, route events, repeat.
    ``capacity`` bounds the WAIT queue (default
    ``serving_queue_capacity``)."""

    def __init__(self, engine, capacity=None, continuous=True):
        self.engine = engine
        self.continuous = bool(continuous)
        self.capacity = int(get_flag("serving_queue_capacity")
                            if capacity is None else capacity)
        self._pending = deque()
        self._cancels = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._handles = {}            # stream -> engine handle
        self._n_requests = 0
        self._n_rejected = 0
        self._n_steps = 0
        self._n_tokens = 0
        self._n_ttft_discarded = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens, sampling=None):
        """Queue one generation request; returns its :class:`TokenStream`.
        Rejects fast with :class:`ServerOverloaded` when ``capacity``
        requests already wait (in-flight sequences don't count)."""
        sampling = normalize_sampling(sampling)   # reject bad specs here
        stream = TokenStream(self)
        req = _Pending(list(prompt), int(max_new_tokens), sampling, stream,
                       time.perf_counter())
        with self._cv:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            self._n_requests += 1
            if len(self._pending) >= self.capacity:
                self._n_rejected += 1
                raise ServerOverloaded(
                    f"generation queue full ({self.capacity} requests "
                    "waiting); back off and retry")
            self._pending.append(req)
            self._cv.notify_all()
        return stream

    def _cancel(self, stream):
        with self._cv:
            self._cancels.append(stream)
            self._cv.notify_all()

    # ------------------------------------------------------------------
    # per-request telemetry (TTFT / TPOT), worker side under _cv
    # ------------------------------------------------------------------
    def _note_emit_locked(self, stream, tokens):
        """The first actual token stamps the TTFT probe; every emission
        advances the TPOT clock."""
        if not tokens:
            return
        now = time.perf_counter()
        if stream.first_token_s is None and stream._submit_s is not None:
            stream.first_token_s = now - stream._submit_s
            stream._first_emit_t = now
            stream._resolved = True
            self.engine.ttft.observe(stream.first_token_s)
        stream._last_emit_t = now
        stream._ntokens += len(tokens)
        self._n_tokens += len(tokens)

    def _finalize_stream_locked(self, stream):
        """Resolve a stream's probes once, however it ends: an unstamped
        TTFT probe is discarded (counted, never recorded); TPOT records
        once for streams that emitted >= 2 tokens."""
        if not stream._resolved:
            stream._resolved = True
            self._n_ttft_discarded += 1
            return
        if not stream._tpot_done and stream._ntokens >= 2:
            stream._tpot_done = True
            self.engine.tpot.observe(
                (stream._last_emit_t - stream._first_emit_t)
                / (stream._ntokens - 1))

    # ------------------------------------------------------------------
    def _run(self):
        while True:
            with self._cv:
                while (not self._pending and not self._cancels
                       and not self._handles and not self._closed):
                    self._cv.wait()
                if self._closed and not self._handles:
                    self._reject_queued_locked()
                    return
                self._apply_cancels_locked()
                self._admit_locked()
            try:
                events = self.engine.step()
            except Exception as e:
                # a step failure poisons every in-flight sequence, which
                # each stream's consumer sees as the error
                with self._cv:
                    for stream, handle in list(self._handles.items()):
                        self.engine.abort(handle)
                        self._finalize_stream_locked(stream)
                        stream._finish(e)
                    self._handles.clear()
                continue
            with self._cv:
                self._route_locked(events)

    def _apply_cancels_locked(self):
        while self._cancels:
            stream = self._cancels.popleft()
            handle = self._handles.pop(stream, None)
            if handle is not None:
                self.engine.abort(handle)
                self._finalize_stream_locked(stream)
            else:
                # not started yet: drop it from the wait queue
                for req in list(self._pending):
                    if req.stream is stream:
                        self._pending.remove(req)
                        break
            stream._finish(_Cancelled("generation cancelled"))

    def _admit_locked(self):
        """FIFO admission. Continuous mode admits whenever the head fits;
        gang mode opens an admission round only when the batch is empty,
        fills it, then waits for every member to finish."""
        if not self.continuous and self._handles:
            return
        while self._pending and not self._closed:
            req = self._pending[0]
            try:
                handle, first, finished = self.engine.start(
                    req.prompt, req.max_new, req.sampling)
            except (NoFreeSlots, CacheExhausted):
                break                  # the head waits for capacity
            except Exception as e:     # a bad request (typed ValueError)
                self._pending.popleft()
                req.stream._finish(e)
                continue
            self._pending.popleft()
            req.stream._submit_s = req.submit_s
            # TTFT is stamped at the first actual token: a beam or
            # chunked-prefill admission emits nothing yet
            self._note_emit_locked(req.stream, first)
            req.stream._emit(first)
            if finished:
                self._finalize_stream_locked(req.stream)
                req.stream._finish()
            else:
                handle.user_data = req.stream
                self._handles[req.stream] = handle

    def _route_locked(self, events):
        if events:
            self._n_steps += 1
        for handle, tokens, finished in events:
            stream = handle.user_data
            if stream is None or stream not in self._handles:
                continue               # cancelled mid-step
            self._note_emit_locked(stream, tokens)
            stream._emit(tokens)
            if finished:
                del self._handles[stream]
                self._finalize_stream_locked(stream)
                stream._finish()

    # ------------------------------------------------------------------
    def _reject_queued_locked(self):
        err = RuntimeError("ContinuousBatcher is closed; this queued "
                           "request was rejected without being served")
        while self._pending:
            self._pending.popleft().stream._finish(err)

    def close(self, timeout=30.0):
        """Stop admitting, let in-flight sequences finish, reject
        still-queued requests typed, and join the worker. Returns True
        when the worker exited in time."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout)
        closed_clean = not self._worker.is_alive()
        if not closed_clean:
            with self._cv:
                self._reject_queued_locked()
        return closed_clean

    def stats(self):
        with self._cv:
            return {
                "queue_depth": len(self._pending),
                "capacity": self.capacity,
                "continuous": self.continuous,
                "in_flight": len(self._handles),
                "requests": self._n_requests,
                "rejected": self._n_rejected,
                "steps": self._n_steps,
                "tokens_emitted": self._n_tokens,
                "ttft_discarded": self._n_ttft_discarded,
                "ttft": self.engine.ttft.snapshot(),
                "tpot": self.engine.tpot.snapshot(),
            }


__all__ = ["ContinuousBatcher", "TokenStream"]
