"""CSP concurrency: Go blocks and typed channels (counterpart of
paddle_tpu/fluid/concurrency.py).

Channels coordinate host-side concurrency, as in the reference: a channel
is a host object (a bounded queue with channel_impl.h's close semantics:
a send on a closed channel raises, a receive on a closed and drained one
returns not-ok), and a Go block runs a Python callable, or the ``go`` op
its captured sub-block, on a daemon thread against the shared scope (the
go_op thread-pool contract). Tensors cross into a program through feeds
or through the channel ops, which keep the channel object in the scope.
"""

from __future__ import annotations

import queue
import threading

__all__ = ["Channel", "make_channel", "channel_send", "channel_recv",
           "channel_close", "Go", "Select"]


class ChannelClosed(Exception):
    pass


class Channel:
    """Bounded typed channel (framework/channel_impl.h semantics):
    capacity=0 means rendezvous (unbuffered) — a send blocks until a
    receiver takes the value."""

    def __init__(self, dtype="float32", capacity=0):
        self.dtype = dtype
        self.capacity = capacity
        # queue.Queue(0) is UNBOUNDED; emulate rendezvous with maxsize 1 +
        # a handshake event per item
        self._q = queue.Queue(maxsize=capacity if capacity > 0 else 1)
        self._unbuffered = capacity == 0
        self._closed = threading.Event()
        self._taken = threading.Condition()
        self._outstanding = 0
        self._waiting_receivers = 0
        self._recv_interest = False

    def send(self, value, timeout=None):
        """True on success; raises ChannelClosed if the channel is closed
        (channel_impl.h Send PADDLE_ENFORCE on closed)."""
        if self._closed.is_set():
            raise ChannelClosed("send on closed channel")
        self._q.put(value, timeout=timeout)
        if self._unbuffered:
            with self._taken:
                self._outstanding += 1
                while self._outstanding > 0 and not self._closed.is_set():
                    if not self._taken.wait(timeout=timeout or 30.0):
                        raise TimeoutError("unbuffered send never received")
        return True

    def recv(self, timeout=None):
        """(value, ok): ok False iff closed and drained
        (channel_impl.h Receive)."""
        with self._taken:
            self._waiting_receivers += 1
        try:
            while True:
                try:
                    v = self._q.get(timeout=0.05)
                    if self._unbuffered:
                        with self._taken:
                            self._outstanding -= 1
                            self._taken.notify_all()
                    return v, True
                except queue.Empty:
                    if self._closed.is_set() and self._q.empty():
                        return None, False
                    if timeout is not None:
                        timeout -= 0.05
                        if timeout <= 0:
                            raise TimeoutError("channel recv timed out")
        finally:
            with self._taken:
                self._waiting_receivers -= 1

    def close(self):
        self._closed.set()
        with self._taken:
            self._taken.notify_all()

    # ---- non-blocking probes (the Select building blocks) ----
    def try_recv(self):
        """(value, ok, ready): ready False when nothing is available yet;
        (None, False, True) once closed-and-drained — mirroring the ready
        states select_op.cc polls for (operators/select_op.cc
        QueueListenerThread readiness checks)."""
        try:
            v = self._q.get_nowait()
        except queue.Empty:
            if self._closed.is_set():
                return None, False, True
            if self._unbuffered:
                # a polling Select recv case IS a momentarily-ready
                # receiver: advertise it so a peer Select's send case can
                # rendezvous (without this, send-Select and recv-Select on
                # one unbuffered channel would livelock — each side polling,
                # neither ever "waiting")
                with self._taken:
                    self._recv_interest = True
            return None, False, False
        if self._unbuffered:
            with self._taken:
                self._outstanding -= 1
                self._taken.notify_all()
        return v, True, True

    def try_send(self, value):
        """True if the value was accepted without blocking. An unbuffered
        channel only accepts when a receiver is actually waiting (the
        reference select_op keeps the send case not-ready otherwise —
        parking a value with no receiver would let Select fire a case the
        rendezvous semantics say must block); a closed channel raises,
        like send."""
        if self._closed.is_set():
            raise ChannelClosed("send on closed channel")
        if self._unbuffered:
            with self._taken:
                if self._waiting_receivers <= self._outstanding \
                        and not self._recv_interest:
                    return False
                try:
                    self._q.put_nowait(value)
                except queue.Full:
                    return False
                self._outstanding += 1
                self._recv_interest = False
            return True
        try:
            self._q.put_nowait(value)
        except queue.Full:
            return False
        return True


def make_channel(dtype, capacity=0):
    return Channel(dtype, capacity)


def channel_send(channel, value, timeout=None):
    return channel.send(value, timeout=timeout)


def channel_recv(channel, timeout=None):
    return channel.recv(timeout=timeout)


def channel_close(channel):
    channel.close()


class Go:
    """Run a python block concurrently (the go_op thread-pool contract,
    operators/go_op.cc / reference concurrency.py Go). Usage:

        with fluid.Go() as g:
            @g.run
            def producer():
                for x in data:
                    fluid.channel_send(ch, x)
                fluid.channel_close(ch)

    Threads are daemons; ``g.join()`` waits for completion (the reference's
    go_op detaches the same way — joins only at scope teardown)."""

    def __init__(self, name=None):
        self._threads = []

    def __enter__(self):
        return self

    def run(self, fn):
        t = threading.Thread(target=fn, daemon=True)
        t.start()
        self._threads.append(t)
        return fn

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False

    def join(self, timeout=None):
        for t in self._threads:
            t.join(timeout)


class Select:
    """CSP select over host channels (reference fluid/concurrency.py:193
    Select + operators/select_op.cc): register send/recv cases and an
    optional default, then ``run()`` fires the FIRST READY case exactly once.
    With no ready case, ``run`` blocks polling until one becomes ready —
    unless a default case exists, which then fires immediately
    (select_op.cc's default-case fallthrough).

    The reference builds conditional_block sub-graphs gated by a
    case_to_execute variable; here (channels being host objects, see module
    docstring) cases are Python callables:

        sel = fluid.Select()

        @sel.case(fluid.channel_recv, ch1)
        def on_recv(value, ok):
            ...

        @sel.case(fluid.channel_send, ch2, x)
        def on_send():
            ...

        @sel.default
        def on_default():
            ...

        fired = sel.run()     # index of the case that executed
    """

    _POLL = 0.002

    def __init__(self, name=None):
        self._cases = []          # (kind, channel, value, body)
        self._default = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False

    def case(self, channel_action_fn, channel, value=None, is_copy=False):
        """Register a case; channel_action_fn is fluid.channel_send or
        fluid.channel_recv (the reference's calling convention)."""
        kind = "send" if channel_action_fn is channel_send else "recv"
        if channel_action_fn not in (channel_send, channel_recv):
            raise ValueError("case action must be channel_send/channel_recv")
        if kind == "send" and is_copy:
            import copy as _copy
            value = _copy.deepcopy(value)

        def deco(body):
            self._cases.append((kind, channel, value, body))
            return body
        return deco

    def default(self, body):
        if self._default is not None:
            raise ValueError("select already has a default case")
        self._default = body
        return body

    def run(self, timeout=None):
        """Execute exactly one case; returns its registration index
        (len(cases) for the default case)."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            for idx, (kind, ch, value, body) in enumerate(self._cases):
                if kind == "recv":
                    v, ok, ready = ch.try_recv()
                    if ready:
                        body(v, ok)
                        return idx
                else:
                    if ch.try_send(value):
                        body()
                        return idx
            if self._default is not None:
                self._default()
                return len(self._cases)
            if deadline is not None and _time.monotonic() > deadline:
                raise TimeoutError("select: no case became ready")
            _time.sleep(self._POLL)
