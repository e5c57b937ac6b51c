"""Request/response RPC over localhost TCP with a zero-copy tensor wire
format (counterpart of paddle_tpu/distributed/rpc.py, ported whole; the
wire format is the reference's, byte for byte).

Wire form — every message is one of two codecs, tagged per message so mixed
clients interoperate and the server always answers in the caller's codec:

* ``framed`` (default) — a fixed prefix
  ``[tag][n_frames][n_oob][u64 frame lengths...]`` followed by (0) a small
  pickled header holding the message skeleton — kwargs with every ndarray
  replaced by a placeholder — plus per-tensor dtype/shape specs, (1..n_oob)
  pickle protocol-5 out-of-band buffers for arrays nested inside objects
  the skeleton walker does not open, and then one raw frame per tensor,
  written with ``sendall(memoryview)`` straight from the array's buffer and
  read with ``recv_into`` into a preallocated ``np.empty`` of the
  advertised dtype/shape. Array bytes are never pickled.
* ``pickle`` — the legacy codec (one pickled frame).

The codec is numpy-only: a torch object is never put on the wire (sending
one raises ``TypeError``), so a peer of either package decodes every
message without torch. The skeleton's placeholders pickle by module path,
and a frame names them ``paddle_tpu.distributed.rpc._TensorRef`` and
``_SparseRef`` (and ``SparseGrad`` on the pickle codec) whichever package
wrote it: this module writes its own classes under the reference's names,
so the reference decodes its frames into the reference's classes, and
maps exactly those names back onto its own classes when it reads (any
other ``paddle_tpu`` name is refused), so decoding never imports the
reference package, and with it JAX. A plain ``pickle.loads`` of a frame
outside both packages would try to import ``paddle_tpu``.

:class:`SparseGrad` is the wire form of a sparse-row gradient: ids +
touched rows only, numpy arrays shipped as raw frames.

Fault tolerance: ``RpcClient`` takes a :class:`RetryPolicy` — a
connection-level failure (server died mid-call, connect refused while it
restarts) is retried by reconnecting and resending, with bounded
exponential backoff + jitter and a hard retry budget. Remote exceptions
and response timeouts are NOT retried. ``RpcServer`` takes a ``fault_plan``
(fault.py) that deterministically drops/delays/severs scheduled calls, and
``kill()`` simulates a crash: the listener closes AND every live connection
is severed.

Accounting: both ends keep a :class:`WireStats` — bytes sent/received and
per-method call counts/latency — and every client call and served request
runs inside a ``core.profiler`` span (kind="rpc").
"""

from __future__ import annotations

import hmac
import io
import os
import pickle
import random
import re
import socket
import struct
import threading
import time
import traceback
from multiprocessing import AuthenticationError

import numpy as np

from types import GeneratorType

from ..core.flags import get_flag
from ..core.profiler import (current_trace_id, new_trace_id, record_event,
                             reset_trace_id, set_trace_id, trace_context)
from ..obs.metrics import REGISTRY as _METRICS

AUTHKEY = b"paddle-tpu-rpc"

# identifier-shaped method names only reach the registry's method label
# (see WireStats.note); anything else funnels into "__other__"
_NAME_OK_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")

_MAGIC = b"PDTPU-RPC-1."          # handshake hello prefix (12 bytes)
_WELCOME = b"WELCOME!"
_HANDSHAKE_TIMEOUT_S = 10.0

WIRE_FRAMED = "framed"
WIRE_PICKLE = "pickle"
_TAG = {WIRE_FRAMED: b"F", WIRE_PICKLE: b"P"}
_UNTAG = {v: k for k, v in _TAG.items()}

# prefix: codec tag, frame count, how many frames are pickle-5 out-of-band
_PREFIX = struct.Struct("<cII")
_FLEN = struct.Struct("<Q")
_MAX_FRAMES = 65536               # sanity bound against corrupt prefixes


class SparseGrad:
    """Sparse-row gradient wire form: ``values[i]`` is the gradient for row
    ``rows[i]`` of a dense ``[nrows, ...]`` parameter — the reference's
    SelectedRows over the wire (operators/detail/sendrecvop_utils.cc
    serializes rows + a dense value block the same way). Numpy-only;
    trainers convert ``core.sparse.SparseRows`` via
    :meth:`from_sparse_rows`.

    ``merged`` promises rows are duplicate-free (post MergeAdd); unmerged
    grads are merged server-side by :meth:`merged_rows`."""

    __slots__ = ("rows", "values", "nrows", "merged")

    def __init__(self, rows, values, nrows, merged=False):
        rows = np.asarray(rows)
        values = np.asarray(values)
        if rows.ndim != 1:
            raise ValueError(f"rows must be 1-d, got shape {rows.shape}")
        if values.shape[:1] != rows.shape:
            raise ValueError(
                f"values rows ({values.shape[0] if values.ndim else '?'}) "
                f"!= ids ({rows.shape[0]})")
        self.rows = rows
        self.values = values
        self.nrows = int(nrows)
        self.merged = bool(merged)

    @classmethod
    def from_sparse_rows(cls, sr):
        """Convert a ``core.sparse.SparseRows`` (torch tensors, sentinel
        padding rows == nrows) to the wire form: host numpy arrays with the
        padding entries filtered out, so wire bytes are O(real touched
        rows). bfloat16 values travel as float32 (numpy has no bfloat16;
        the receiver accumulates in float32 anyway)."""
        nrows = int(sr.nrows)
        rows = _host(sr.rows)
        values = _host(sr.values)
        keep = (rows >= 0) & (rows < nrows)
        if not bool(keep.all()):
            rows, values = rows[keep], values[keep]
        return cls(rows, values, nrows, bool(getattr(sr, "merged", False)))

    @property
    def nbytes(self):
        return self.rows.nbytes + self.values.nbytes

    def astype(self, dtype):
        return SparseGrad(self.rows, self.values.astype(dtype), self.nrows,
                          self.merged)

    def merged_rows(self):
        """MergeAdd (operators/math/selected_rows_functor.cc): combine
        duplicate ids by summation. Returns ``(unique_rows, fp32_values)``
        — accumulation is always fp32 regardless of the wire dtype."""
        vals = self.values.astype(np.float32, copy=False)
        if self.merged:
            return self.rows, vals
        uniq, inv = np.unique(self.rows, return_inverse=True)
        out = np.zeros((len(uniq),) + self.values.shape[1:], np.float32)
        np.add.at(out, inv, vals)
        return uniq, out

    def to_dense(self):
        """Densify to fp32 ``[nrows, ...]`` (duplicates summed)."""
        out = np.zeros((self.nrows,) + self.values.shape[1:], np.float32)
        np.add.at(out, self.rows,
                  self.values.astype(np.float32, copy=False))
        return out

    def __reduce__(self):
        # plain-pickle wire (and disk checkpoints) round-trip SparseGrad
        # through its arrays; protocol 5 extracts them out-of-band
        return (SparseGrad, (self.rows, self.values, self.nrows,
                             self.merged))

    def __repr__(self):
        return (f"SparseGrad(n={self.rows.shape[0]}, nrows={self.nrows}, "
                f"dim={tuple(self.values.shape[1:])}, "
                f"dtype={self.values.dtype}, merged={self.merged})")


class _TensorRef:
    """Skeleton placeholder for the i-th raw tensor frame."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i

    def __reduce__(self):
        return (_TensorRef, (self.i,))


class _SparseRef:
    """Skeleton placeholder for a SparseGrad whose rows/values ship as raw
    tensor frames ri and vi."""

    __slots__ = ("ri", "vi", "nrows", "merged")

    def __init__(self, ri, vi, nrows, merged):
        self.ri = ri
        self.vi = vi
        self.nrows = nrows
        self.merged = merged

    def __reduce__(self):
        return (_SparseRef, (self.ri, self.vi, self.nrows, self.merged))


def _host(t):
    """A torch tensor (any device) or array-like as a host numpy array."""
    if hasattr(t, "detach"):
        t = t.detach()
        if str(t.dtype) == "torch.bfloat16":
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _is_torch(obj):
    return type(obj).__module__.split(".")[0] == "torch"


def _no_torch(obj):
    raise TypeError(
        f"a {type(obj).__module__}.{type(obj).__name__} cannot go on the "
        "wire: the codec is numpy-only (send tensor.cpu().numpy(), and "
        "plain builtins for devices and sizes)")


class _WirePickler(pickle._Pickler):
    """The codec's pickler. It writes the wire classes (_TensorRef,
    _SparseRef, SparseGrad) under the reference's names (_WIRE_NAMES), so
    a frame from this package is the frame the reference writes and a
    reference peer decodes it into its own classes, and it refuses torch
    objects. The Python pickler, because only its ``save_global`` can be
    told a name: the skeletons it pickles are small."""

    def reducer_override(self, obj):
        if _is_torch(obj):
            _no_torch(obj)
        return NotImplemented

    def save_global(self, obj, name=None):
        wire = _WIRE_NAMES.get(obj) if isinstance(obj, type) else None
        if wire is None or self.proto < 4:
            return super().save_global(obj, name)
        self.save(wire[0])
        self.save(wire[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _dumps(obj, protocol=None, buffer_callback=None):
    buf = io.BytesIO()
    _WirePickler(buf, protocol, buffer_callback=buffer_callback).dump(obj)
    return buf.getvalue()


class _WireUnpickler(pickle.Unpickler):
    """Decode a frame without importing the reference package: its wire
    classes' names map onto this module's classes (_WIRE_NAMES); any other
    ``paddle_tpu`` name is refused."""

    def find_class(self, module, name):
        if module == "paddle_tpu" or module.startswith("paddle_tpu."):
            local = _WIRE_CLASSES.get((module, name))
            if local is None:
                raise pickle.UnpicklingError(
                    f"frame names {module}.{name}; this package decodes "
                    "only the reference's wire placeholders and never "
                    "imports paddle_tpu")
            return local
        return super().find_class(module, name)


def _loads(data, buffers=None):
    return _WireUnpickler(io.BytesIO(data), buffers=buffers).load()


def _strip(obj, specs, tensors):
    """Replace every ndarray leaf in dict/list/tuple containers with a
    _TensorRef, recording (dtype, shape) specs and the contiguous array for
    raw framing. Anything else stays in the skeleton; arrays hidden inside
    unopened objects still avoid a copy via pickle-5 out-of-band buffers."""
    if isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
        # keep 0-d arrays 0-d: ascontiguousarray would promote () to (1,)
        a = obj if obj.flags.c_contiguous else np.ascontiguousarray(obj)
        specs.append((a.dtype.str, a.shape))
        tensors.append(a)
        return _TensorRef(len(specs) - 1)
    if _is_torch(obj):
        _no_torch(obj)
    if isinstance(obj, SparseGrad):
        r = _strip(obj.rows, specs, tensors)
        v = _strip(obj.values, specs, tensors)
        return _SparseRef(r.i, v.i, obj.nrows, obj.merged)
    if type(obj) is dict:
        return {k: _strip(v, specs, tensors) for k, v in obj.items()}
    if type(obj) is list:
        return [_strip(v, specs, tensors) for v in obj]
    if type(obj) is tuple:
        return tuple(_strip(v, specs, tensors) for v in obj)
    return obj


# the wire classes and the (module, name) a frame names them by: the
# reference's, whichever package wrote the frame
_WIRE_NAMES = {cls: ("paddle_tpu.distributed.rpc", cls.__name__)
               for cls in (_TensorRef, _SparseRef, SparseGrad)}
_WIRE_CLASSES = {v: k for k, v in _WIRE_NAMES.items()}


def _fill(obj, arrays):
    """Inverse of _strip: graft the received tensors back into the
    skeleton."""
    if isinstance(obj, _TensorRef):
        return arrays[obj.i]
    if isinstance(obj, _SparseRef):
        return SparseGrad(arrays[obj.ri], arrays[obj.vi], obj.nrows,
                          obj.merged)
    if type(obj) is dict:
        return {k: _fill(v, arrays) for k, v in obj.items()}
    if type(obj) is list:
        return [_fill(v, arrays) for v in obj]
    if type(obj) is tuple:
        return tuple(_fill(v, arrays) for v in obj)
    return obj


def send_msg(sock, obj, wire=WIRE_FRAMED):
    """Encode + send one message; returns bytes written. Framed messages
    write tensor bytes straight from the array buffers (no pickling of
    array data); small messages coalesce into a single send so the
    request/response ping-pong stays one packet each way."""
    if wire == WIRE_PICKLE:
        frames = [_dumps(obj)]
        n_oob = 0
    else:
        specs, tensors, oob = [], [], []
        skeleton = _strip(obj, specs, tensors)
        head = _dumps((skeleton, specs), protocol=5,
                      buffer_callback=oob.append)
        frames = ([head] + [b.raw() for b in oob]
                  + [memoryview(a).cast("B") if a.nbytes else b""
                     for a in tensors])
        n_oob = len(oob)
    prefix = (_PREFIX.pack(_TAG[wire], len(frames), n_oob)
              + b"".join(_FLEN.pack(len(f)) for f in frames))
    total = len(prefix) + sum(len(f) for f in frames)
    if total <= 65536:
        sock.sendall(b"".join([prefix, *frames]))
    else:
        sock.sendall(prefix)
        for f in frames:
            sock.sendall(f)
    return total


def _recv_into(sock, view):
    while len(view):
        n = sock.recv_into(view)
        if n == 0:
            raise EOFError("connection closed mid-message")
        view = view[n:]


def _recv_exact(sock, n):
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return buf


def recv_msg(sock):
    """Receive one message; returns ``(obj, bytes_read, wire)``. Framed
    tensor frames are read with ``recv_into`` directly into preallocated
    arrays of the header-advertised dtype/shape — the zero-copy half of
    the codec."""
    prefix = _recv_exact(sock, _PREFIX.size)
    tag, n_frames, n_oob = _PREFIX.unpack(bytes(prefix))
    if tag not in _UNTAG or not 1 <= n_frames <= _MAX_FRAMES \
            or n_oob >= n_frames or (tag == b"P" and n_frames != 1):
        # a pickle-tagged message is exactly one frame; accepting more
        # would leave unread frames to desync the stream
        raise EOFError(f"corrupt message prefix {bytes(prefix)!r}")
    lens = struct.unpack(f"<{n_frames}Q", _recv_exact(sock, 8 * n_frames))
    total = _PREFIX.size + 8 * n_frames + sum(lens)
    if tag == b"P":
        payload = _recv_exact(sock, lens[0])
        return _loads(payload), total, WIRE_PICKLE
    head = _recv_exact(sock, lens[0])
    oob = [_recv_exact(sock, n) for n in lens[1:1 + n_oob]]
    skeleton, specs = _loads(head, buffers=oob)
    if len(specs) != n_frames - 1 - n_oob:
        raise EOFError("tensor spec count does not match frame count")
    arrays = []
    for (dt, shape), n in zip(specs, lens[1 + n_oob:]):
        a = np.empty(shape, dtype=np.dtype(dt))
        if a.nbytes != n:
            raise EOFError(f"tensor frame length {n} != {a.nbytes} "
                           f"for dtype {dt} shape {shape}")
        if a.nbytes:
            _recv_into(sock, memoryview(a).cast("B"))
        arrays.append(a)
    return _fill(skeleton, arrays), total, WIRE_FRAMED


# ---------------------------------------------------------------------------
# authkey handshake (the multiprocessing.connection challenge, inlined over
# the raw socket so the data path owns the fd end to end)
# ---------------------------------------------------------------------------

def _server_handshake(sock):
    challenge = os.urandom(20)
    sock.sendall(_MAGIC + challenge)
    digest = bytes(_recv_exact(sock, 32))
    expect = hmac.new(AUTHKEY, challenge, "sha256").digest()
    if not hmac.compare_digest(digest, expect):
        raise AuthenticationError("digest received was wrong")
    sock.sendall(_WELCOME)


def _client_handshake(sock):
    hello = bytes(_recv_exact(sock, len(_MAGIC) + 20))
    if hello[:len(_MAGIC)] != _MAGIC:
        raise AuthenticationError(f"bad hello {hello[:len(_MAGIC)]!r}")
    sock.sendall(hmac.new(AUTHKEY, hello[len(_MAGIC):], "sha256").digest())
    if bytes(_recv_exact(sock, len(_WELCOME))) != _WELCOME:
        raise AuthenticationError("server rejected the digest")


# process-wide wire accounting (obs.metrics plane): every WireStats mirrors
# its per-endpoint counters into these role-labeled aggregates, so the
# built-in ``metrics`` scrape sees total wire traffic without per-endpoint
# label cardinality (a router's connection pool alone holds dozens of
# clients); the per-endpoint detail stays on each WireStats.snapshot().
_WIRE_BYTES_SENT = _METRICS.counter(
    "paddle_tpu_wire_bytes_sent",
    "bytes written to RPC sockets, by endpoint role", labels=("role",))
_WIRE_BYTES_RECV = _METRICS.counter(
    "paddle_tpu_wire_bytes_recv",
    "bytes read from RPC sockets, by endpoint role", labels=("role",))
_WIRE_CALLS = _METRICS.counter(
    "paddle_tpu_wire_calls",
    "RPC calls noted by WireStats, by role and method",
    labels=("role", "method"))
_WIRE_CALL_SECONDS = _METRICS.histogram(
    "paddle_tpu_wire_call_seconds",
    "RPC call latency windows, by role and method",
    labels=("role", "method"), span_kind="rpc")


class WireStats:
    """Bytes + call-latency counters for one endpoint. ``role`` labels the
    process-wide registry mirror ("client"/"server"); ``snapshot()`` keeps
    the exact per-endpoint view (cheap and picklable, so a server's
    counters travel inside ``stats()`` responses)."""

    def __init__(self, role="client"):
        self._lock = threading.Lock()
        self.role = str(role)
        self.bytes_sent = 0
        self.bytes_recv = 0
        self._calls = {}   # method -> [count, total_s, max_s]
        self._m_sent = _WIRE_BYTES_SENT.labels(role=self.role)
        self._m_recv = _WIRE_BYTES_RECV.labels(role=self.role)
        self._m_methods = {}  # method -> (calls child, seconds child)

    # process-wide method-label cardinality bound: method names arrive
    # off the WIRE on the server side, so a misbehaving peer calling
    # arbitrary names must not grow unbounded (scrape-visible, never
    # reclaimed) registry series — past the cap, or for a non-identifier
    # name, the registry mirror funnels into the "__other__" label (the
    # per-endpoint ``snapshot()`` keeps exact names; it dies with the
    # endpoint)
    _METHOD_LABEL_CAP = 64

    def note(self, method, sent, recvd, seconds):
        # coerce at the source: numpy byte counts from buffer walkers
        # must never leak into snapshot()/stats() payloads
        sent, recvd, seconds = int(sent), int(recvd), float(seconds)
        with self._lock:
            self.bytes_sent += sent
            self.bytes_recv += recvd
            rec = self._calls.setdefault(method, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += seconds
            rec[2] = max(rec[2], seconds)
            mc = self._m_methods.get(method)
            if mc is None:
                label = method if isinstance(method, str) \
                    and _NAME_OK_RE.match(method) \
                    and len(self._m_methods) < self._METHOD_LABEL_CAP \
                    else "__other__"
                mc = self._m_methods[method] = (
                    _WIRE_CALLS.labels(role=self.role, method=label),
                    _WIRE_CALL_SECONDS.labels(role=self.role,
                                              method=label))
        self._m_sent.inc(sent)
        self._m_recv.inc(recvd)
        mc[0].inc()
        mc[1].observe(seconds)

    def snapshot(self):
        with self._lock:
            return {
                "bytes_sent": self.bytes_sent,
                "bytes_recv": self.bytes_recv,
                "calls": {m: {"count": c, "total_s": t, "max_s": mx}
                          for m, (c, t, mx) in self._calls.items()},
            }


def _parse_request(req):
    """Unpack a request message: the legacy 2-tuple ``(method, kwargs)``
    or the current 3-tuple ``(method, kwargs, meta)`` where ``meta``
    carries the trace id (``{"trace": ...}``). An absent meta field means
    a legacy peer — fully served, no migration."""
    method, kwargs = req[0], req[1]
    meta = req[2] if len(req) > 2 and isinstance(req[2], dict) else {}
    return method, kwargs, meta


def _builtin_metrics():
    """The built-in ``metrics`` RPC every RpcServer answers (unless its
    handler defines its own): a JSON-safe snapshot of this process's
    obs.metrics registry — the per-process scrape endpoint
    ``tools/metrics_dump.py`` and ``FleetSupervisor.fleet_metrics()``
    read."""
    from ..obs import metrics as _m
    return _m.json_safe(_m.REGISTRY.snapshot())


def _builtin_flight_dump():
    """The built-in ``flight_dump`` RPC (the ``metrics`` twin): this
    process's flight-recorder ring — what ``tools/dump_flight.py`` and
    ``obs.recorder.capture_bundle`` scrape into incident bundles."""
    from ..obs import recorder as _r
    return _r.RECORDER.dump()


_BUILTIN_METHODS = {"metrics": _builtin_metrics,
                    "flight_dump": _builtin_flight_dump}


class RemoteError(RuntimeError):
    """A handler exception surfaced across the wire as a STRUCTURED error:
    ``code`` is the remote exception's type name (machine-checkable — the
    serving router keys its ``ServerOverloaded`` spillover on it instead of
    sniffing message substrings), ``remote_message`` the remote ``str(e)``,
    and ``remote_traceback`` the remote stack — preserved so a failure deep
    inside a replica is diagnosable from the client side. Subclasses
    RuntimeError, so callers that only catch the legacy bare type keep
    working."""

    def __init__(self, method, code, message, remote_traceback=None):
        self.method = method
        self.code = code
        self.remote_message = message
        self.remote_traceback = remote_traceback
        text = f"remote {method} failed: {code}: {message}"
        if remote_traceback:
            text += ("\n--- remote traceback ---\n"
                     + str(remote_traceback).rstrip())
        super().__init__(text)

    @classmethod
    def from_payload(cls, method, payload):
        """Build from a server error payload: the structured dict form
        (``{"code", "message", "traceback"}``) or the legacy
        ``"TypeName: message"`` string a pre-upgrade server sends."""
        if isinstance(payload, dict):
            return cls(method, payload.get("code", "RuntimeError"),
                       payload.get("message", ""), payload.get("traceback"))
        code, sep, msg = str(payload).partition(": ")
        if not sep:
            code, msg = "RuntimeError", str(payload)
        return cls(method, code, msg)


class RetryPolicy:
    """Bounded exponential backoff + jitter for reconnect-and-resend.

    ``max_retries`` is the budget of RE-sends (a call makes at most
    1 + max_retries attempts). Delay before attempt k (1-based) is
    ``min(backoff_max_s, backoff_base_s * 2**(k-1))`` stretched by up to
    ``jitter`` (uniform), so a fleet of trainers retrying a restarted
    pserver doesn't stampede it in lockstep.
    """

    def __init__(self, max_retries=5, backoff_base_s=0.05, backoff_max_s=1.0,
                 jitter=0.25):
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)

    def delay_s(self, attempt):
        base = min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** (attempt - 1)))
        return base * (1.0 + self.jitter * random.random())


class RpcServer:
    """Serve ``handler`` (an object whose public methods are the RPC
    surface) on ``address`` until ``shutdown`` is called or the process
    dies. One thread per connection — the reference's completion-queue
    concurrency scoped to localhost control traffic. Responses are encoded
    in the codec of the request they answer, so framed and legacy-pickle
    clients can share one server."""

    def __init__(self, handler, address=("127.0.0.1", 0), fault_plan=None):
        self._handler = handler
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(tuple(address))
        self._listener.listen(16)
        # cache the bound address: getsockname() on a closed listener is
        # EBADF, but callers legitimately ask a drained/killed server
        # where it WAS (restart-on-same-address, post-shutdown asserts)
        self._address = self._listener.getsockname()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._threads = []
        self._fault = fault_plan
        self._conns = set()          # live connections, for kill()
        self._conns_lock = threading.Lock()
        # in-flight request count + wakeup for drain(): a request is
        # active from the moment it is fully received until its response
        # is sent (or dropped). _drain_finalized closes the race where a
        # request finishes its recv after drain() observed active == 0:
        # such a request is dropped UNAPPLIED instead of being half-served
        self._active = 0
        self._active_cv = threading.Condition()
        self._drain_finalized = False
        # the accept loop's thread, and its exit: closing the listener
        # waits for it (see _wake_and_close_listener)
        self._accept_thread = None
        self._accept_done = threading.Event()
        self.wire_stats = WireStats(role="server")

    @property
    def address(self):
        return self._address

    def serve_forever(self):
        self._accept_thread = threading.current_thread()
        try:
            self._accept_loop()
        finally:
            self._accept_done.set()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _peer = self._listener.accept()
            except OSError:
                # listener closed (shutdown) or fd exhaustion: exit rather
                # than hot-spin on a broken listener
                break
            if self._stop.is_set() or self._draining.is_set():
                conn.close()
                break
            # the authkey handshake runs in the connection's own thread, so
            # a client that vanishes mid-handshake (an elastic trainer
            # killed at the wrong moment) never stalls or kills the accept
            # loop — later clients keep getting served
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            # prune finished handler threads so long-lived servers don't
            # leak one Thread object per reconnect
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def serve_in_thread(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def _serve_conn(self, conn):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(_HANDSHAKE_TIMEOUT_S)
            _server_handshake(conn)
            conn.settimeout(None)
        except Exception:
            # vanished/impostor client: drop it, keep serving others
            conn.close()
            return
        with self._conns_lock:
            self._conns.add(conn)
        try:
            while not self._stop.is_set():
                try:
                    req, nr, wire = recv_msg(conn)
                    method, kwargs, meta = _parse_request(req)
                except Exception:
                    # EOF/OSError: client vanished or kill() severed us;
                    # decode/shape errors: a corrupt stream is
                    # unrecoverable mid-connection either way
                    return
                with self._active_cv:
                    if self._drain_finalized:
                        # this request lost the race with drain()'s idle
                        # declaration: sever WITHOUT applying (the same
                        # outcome as arriving after the kill that follows)
                        return
                    self._active += 1
                gen = None
                # restore the client's trace id (wire meta) into the
                # contextvar for the whole handling of this request, so
                # server-side profiler spans share the caller's id
                trace_tok = set_trace_id(meta["trace"]) \
                    if meta.get("trace") else None
                try:
                    if method == "__shutdown__":
                        send_msg(conn, (True, None), wire)
                        self.shutdown()
                        return
                    rule = self._fault.on_call(method) \
                        if self._fault is not None else None
                    if rule is not None and rule.kind == "delay":
                        time.sleep(rule.seconds)
                        rule.fired.set()
                        rule = None          # then serve normally
                    if rule is not None and rule.kind == "drop_request":
                        rule.fired.set()
                        return               # sever; method never applied
                    if rule is not None and rule.kind == "die_before":
                        self.kill()
                        rule.fired.set()
                        return
                    t0 = time.perf_counter()
                    try:
                        if method in _BUILTIN_METHODS \
                                and not hasattr(self._handler, method):
                            # built-in scrape surfaces: every RpcServer
                            # answers the obs.metrics registry snapshot
                            # (``metrics``) and the flight-recorder ring
                            # (``flight_dump``); handler-defined methods
                            # of the same name win
                            fn = _BUILTIN_METHODS[method]
                        else:
                            fn = getattr(self._handler, method)
                        with record_event(f"rpc.serve/{method}", kind="rpc"):
                            payload = fn(**kwargs)
                        if isinstance(payload, GeneratorType):
                            # STREAMING response: the handler returned a
                            # generator — push one frame per yielded item
                            gen, payload = payload, None
                            result = None
                        else:
                            result = (True, payload)
                    except Exception as e:  # surface remote errors to caller
                        result = (False, {"code": type(e).__name__,
                                          "message": str(e),
                                          "traceback":
                                              traceback.format_exc()})
                    if rule is not None and rule.kind == "drop_response":
                        rule.fired.set()
                        return               # applied, but the reply is lost
                    if rule is not None and rule.kind == "die_after":
                        self.kill()
                        rule.fired.set()
                        return
                    try:
                        if gen is not None:
                            ns = self._stream_response(conn, gen, wire)
                        else:
                            ns = send_msg(conn, result, wire)
                    except Exception:
                        return  # client vanished (or kill()ed) mid-reply
                    self.wire_stats.note(method, ns, nr,
                                         time.perf_counter() - t0)
                finally:
                    if trace_tok is not None:
                        reset_trace_id(trace_tok)
                    if gen is not None:
                        # always unwind the handler generator — a severed
                        # client or drop rule must cancel its work (the
                        # generation scheduler hooks cancellation into
                        # GeneratorExit)
                        try:
                            gen.close()
                        except Exception:
                            pass
                    with self._active_cv:
                        self._active -= 1
                        self._active_cv.notify_all()
                if self._draining.is_set():
                    # drain(): the in-flight request was answered; close
                    # the keep-alive connection instead of taking more work
                    return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _stream_response(self, conn, gen, wire):
        """Multi-frame STREAMING response (the unary codec extended, not
        replaced): a ``("stream", None)`` header message, one
        ``("item", value)`` message per yielded item (tensors ride the
        framed codec zero-copy like any unary payload), and a terminal
        ``("end", None)`` — or ``("error", {code, message, traceback})``
        when the handler generator raises mid-stream, preserving the
        structured RemoteError contract at any point of the stream.
        Returns total bytes sent; send failures (client vanished) raise
        to the caller, which severs the connection and closes the
        generator (cancelling the work behind it)."""
        ns = send_msg(conn, ("stream", None), wire)
        it = iter(gen)
        while True:
            # advance the generator and send OUTSIDE each other's try so
            # an OSError is attributed correctly: from send_msg = client
            # vanished (raise to sever), from the HANDLER's own code = a
            # remote failure that still owes the client its error frame
            try:
                item = next(it)
            except StopIteration:
                break
            except Exception as e:
                ns += send_msg(conn, ("error",
                                      {"code": type(e).__name__,
                                       "message": str(e),
                                       "traceback":
                                           traceback.format_exc()}),
                               wire)
                return ns
            ns += send_msg(conn, ("item", item), wire)
        ns += send_msg(conn, ("end", None), wire)
        return ns

    def _wake_and_close_listener(self):
        """Kick the accept loop out of accept(2) BEFORE closing the
        listener: close() alone does not wake a thread already blocked
        in accept — the in-progress syscall pins the kernel socket, the
        port stays in LISTEN, and a restarted server can't rebind the
        address (the failover contract requires the SAME address). The
        throwaway connection completes the accept; the loop sees
        _stop/_draining and exits. The connect returns before the accept
        does, so the close can still land while accept(2) pins the
        socket: this returns only once the loop has left accept (bounded),
        so the port is free when ``kill``/``shutdown`` return and a
        restart on the same address binds at once."""
        try:
            s = socket.create_connection(self.address, timeout=0.5)
            s.close()
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        t = self._accept_thread
        if t is not None and t is not threading.current_thread():
            self._accept_done.wait(_HANDSHAKE_TIMEOUT_S)

    def shutdown(self):
        self._stop.set()
        self._wake_and_close_listener()

    def drain(self, timeout=30.0):
        """Graceful drain (the model server's shutdown contract): stop
        accepting new connections, let every in-flight request finish and
        be ANSWERED, then close the remaining (idle) connections and the
        listener. Returns True when the server went idle within
        ``timeout``; False means the timeout expired with requests still
        running — the server is closed regardless. A request whose receive
        completes AFTER the idle declaration is dropped unapplied (its
        client sees the same EOF a crash produces — never an applied-but-
        unanswered mutation). Contrast ``shutdown`` (stops serving without
        severing, so blocked in-flight recvs leak) and ``kill`` (severs
        everything immediately, simulating a crash)."""
        self._draining.set()
        self._wake_and_close_listener()
        deadline = time.monotonic() + timeout
        with self._active_cv:
            while self._active > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._active_cv.wait(left)
            drained = self._active == 0
            # finalize under the SAME lock that admits requests: a recv
            # completing after this point sees the flag and drops its
            # request unapplied, so "drained" can never race a request
            # into the applied-but-unanswered state
            self._drain_finalized = True
        # connections now idle in recv are waiting for requests that will
        # never be served; sever them and stop the serve loops
        self.kill()
        return drained

    def kill(self):
        """Simulate a process crash: stop accepting AND sever every live
        connection. ``shutdown()`` alone leaves in-flight connections open
        (a graceful drain); a crashed pserver gives its clients EOF on
        in-flight calls and connection-refused on reconnects — which is
        what retry policies and failover supervisors must handle."""
        self.shutdown()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                # SHUT_RDWR wakes any thread blocked in recv on this socket
                # (a bare close() would leave it blocked forever)
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class RpcClient:
    """Blocking stub: client.call("method", key=value) -> payload.

    Connects lazily (a client may be built while its server is still
    restarting). ``timeout`` defaults to the ``rpc_timeout_s`` flag. A
    timed-out call DISCARDS the connection (the late response would
    otherwise sit in the pipe and be returned as the answer to the next,
    unrelated request); the next call reconnects. ``wire`` picks the codec
    ("framed" zero-copy tensors, default; "pickle" is the legacy baseline).

    With a ``retry`` policy, connection-level failures (EOF mid-call,
    refused connect during a server restart) reconnect and resend within
    the policy's budget. Safe for the pserver surface: ``push`` carries a
    sequence number the server dedups, ``pull``/``init_params``/``stats``
    are idempotent. Leave retry off for non-idempotent surfaces (a retried
    master ``get_task`` would lease two tasks — harmless under the lease-
    timeout contract, but not free)."""

    _RETRYABLE = (EOFError, ConnectionError, BrokenPipeError, OSError)

    def __init__(self, address, timeout=None, retry=None, wire=WIRE_FRAMED):
        if wire not in _TAG:
            raise ValueError(f"unknown wire codec {wire!r}; "
                             f"want one of {sorted(_TAG)}")
        self._address = tuple(address)
        self._sock = None
        self._lock = threading.Lock()
        self._timeout = float(get_flag("rpc_timeout_s")) if timeout is None \
            else float(timeout)
        self._retry = retry
        self._wire = wire
        self.wire_stats = WireStats()

    def _connect(self):
        try:
            s = socket.create_connection(self._address,
                                         timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _client_handshake(s)
        except TimeoutError as e:
            # a connect/handshake timeout is a CONNECTION failure (server
            # still restarting, wedged listener) — retryable, unlike a
            # response timeout on a sent request (which may have applied)
            raise ConnectionError(
                f"connect to {self._address} timed out") from e
        return s

    def _drop_conn(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call_once(self, method, kwargs):
        t0 = time.perf_counter()
        # carry the active trace id in the request header (meta field);
        # call()/stream() ensure one exists, making every RpcClient a
        # client edge of the distributed trace
        tid = current_trace_id()
        msg = (method, kwargs, {"trace": tid}) if tid else (method, kwargs)
        with self._lock:
            if self._sock is None:
                self._sock = self._connect()
            try:
                self._sock.settimeout(self._timeout)
                ns = send_msg(self._sock, msg, self._wire)
                resp, nr, _wire = recv_msg(self._sock)
            except TimeoutError:
                self._drop_conn()
                raise TimeoutError(f"rpc {method} timed out") from None
            except self._RETRYABLE:
                # server died mid-call: discard the dead connection so the
                # next call/attempt reconnects (to a restarted server)
                self._drop_conn()
                raise
            self.wire_stats.note(method, ns, nr, time.perf_counter() - t0)
        ok, payload = resp
        if ok == "stream":
            # a unary call() on a streaming method would leave the item
            # frames in the pipe and desync every later call — drop the
            # connection and point the caller at stream()
            with self._lock:
                self._drop_conn()
            raise RuntimeError(
                f"rpc method {method!r} answered with a STREAM; consume "
                "it with RpcClient.stream(), not call()")
        if not ok:
            raise RemoteError.from_payload(method, payload)
        return payload

    def call(self, method, **kwargs):
        attempt = 0
        # client edge of the distributed trace: reuse the caller's trace
        # id (FleetClient/ParamClient bind one spanning failovers and
        # shard fan-outs) or mint a fresh one for this call — the id rides
        # the request header and every retry resend keeps it
        with trace_context():
            while True:
                try:
                    with record_event(f"rpc.client/{method}", kind="rpc"):
                        return self._call_once(method, kwargs)
                except TimeoutError:
                    # a response timeout is ambiguous (the call may have
                    # applied) and bounded by its own deadline — never
                    # retried
                    raise
                except self._RETRYABLE:
                    if self._retry is None \
                            or attempt >= self._retry.max_retries:
                        raise
                    attempt += 1
                    # back off OUTSIDE the conn lock, then
                    # reconnect-and-resend
                    time.sleep(self._retry.delay_s(attempt))

    def stream(self, method, **kwargs):
        """STREAMING call: a generator yielding the server's item frames
        as they arrive (each within the response ``timeout``), ending at
        the terminal frame. A mid-stream handler failure raises the same
        structured :class:`RemoteError` a unary call gets; the stream is
        positionally intact up to it. A unary response degrades
        gracefully to a one-item stream.

        The client's connection is DEDICATED to the stream until it ends:
        the generator holds the client lock, so concurrent streams (or
        calls during a stream) need separate clients. Abandoning the
        stream early (``close()``/``break``) drops the connection — the
        unread frames can't be left to desync a reused socket — which the
        server observes as a send failure and turns into cancellation of
        the handler generator. No automatic retry: a generation stream is
        stateful, so a resend could replay work; callers retry whole
        streams if their semantics allow."""
        # a generator must not enter trace_context (the contextvar would
        # leak into the consumer between yields); compute the id once and
        # send it explicitly — the server side restores it per request
        tid = current_trace_id() or new_trace_id()
        self._lock.acquire()
        clean = False
        try:
            if self._sock is None:
                self._sock = self._connect()
            try:
                self._sock.settimeout(self._timeout)
                ns = send_msg(self._sock, (method, kwargs,
                                           {"trace": tid}), self._wire)
                self.wire_stats.note(method, ns, 0, 0.0)
                kind, payload = self._recv_frame()
                if kind is True:          # unary answer: one-item stream
                    clean = True
                    yield payload
                    return
                if kind is False:
                    clean = True
                    raise RemoteError.from_payload(method, payload)
                if kind != "stream":
                    raise EOFError(
                        f"corrupt stream header {kind!r} from {method}")
                while True:
                    kind, payload = self._recv_frame()
                    if kind == "item":
                        yield payload
                    elif kind == "end":
                        clean = True
                        return
                    elif kind == "error":
                        clean = True
                        raise RemoteError.from_payload(method, payload)
                    else:
                        raise EOFError(
                            f"corrupt stream frame {kind!r} from {method}")
            except TimeoutError:
                raise TimeoutError(
                    f"rpc stream {method} timed out waiting for the next "
                    "frame") from None
        finally:
            if not clean:
                # abandoned or severed mid-stream: unread frames would
                # desync the next call on this socket
                self._drop_conn()
            self._lock.release()

    def _recv_frame(self):
        obj, nr, _wire = recv_msg(self._sock)
        self.wire_stats.note("<stream-frame>", 0, nr, 0.0)
        return obj

    def close(self):
        with self._lock:
            self._drop_conn()
