"""The port's RPC transport (paddle_tpu_torch/distributed/rpc.py) against the
reference's (paddle_tpu/distributed/rpc.py).

Counterparts of tests/test_pserver_wire.py:80-147 (both codecs carry
identical payloads, framed is smaller, the server answers in the request's
codec), of its RPC-level checks at :505-535 and :560-600 (the
``rpc_timeout_s`` flag, a stuck call bounded by it, the wire counters, the
profiler spans — through a plain ``RpcServer`` handler where the reference
drives a parameter server) and of tests/test_generation_serving.py:363-441
(streaming frames, a mid-stream error, abandoning a stream cancels the
handler's generator, a unary call on a streaming method raises typed).

Across packages: a frame is the same bytes whichever package wrote it; a
frame the reference wrote decodes in a process where ``paddle_tpu`` cannot
be imported, bitwise on every array; a frame the port wrote decodes in the
reference. Every wait is bounded; every server is closed in a ``finally``.
"""

import os
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu.distributed.rpc as jrpc
from paddle_tpu_torch.core import flags, profiler
from paddle_tpu_torch.distributed import FaultPlan, rpc
from paddle_tpu_torch.obs.trace import current_trace_id, trace_context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 5.0
# the bound on a held dispatch, released by the test well before it
GATE_S = 10.0


def _wait_until(pred, timeout=WAIT_S):
    """Poll ``pred`` on an event's bounded wait; True once it holds."""
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        tick.wait(0.005)
    return True


def _payload(mod):
    """The reference test's payload (test_pserver_wire.py:86), built with
    ``mod``'s SparseGrad."""
    return (
        "push",
        {
            "grads": {
                "w": np.arange(24, dtype=np.float32).reshape(4, 6),
                "half": np.ones((3, 2), np.float16),
                "ids": np.array([5, 1, 5], np.int64),
                "scalar0d": np.asarray(np.float32(2.5)),
                "empty": np.empty((0, 4), np.float32),
                "noncontig": np.arange(10, dtype=np.float64)[::2],
                "emb": mod.SparseGrad(np.array([3, 1, 3], np.int64),
                                      np.ones((3, 2), np.float32), nrows=7),
            },
            "trainer_id": 3,
            "seq": 9,
            "note": "control strings ride the skeleton",
            "nested": [1, (2.5, None), {"deep": np.full((2,), 7, np.int32)}],
        },
    )


def _plain(x):
    """Builtins-and-numpy form of a decoded payload (a SparseGrad of either
    package becomes a tagged tuple), for bitwise comparison."""
    if isinstance(x, (rpc.SparseGrad, jrpc.SparseGrad)):
        return ("SparseGrad", x.rows, x.values, x.nrows, x.merged)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


def _assert_same(x, y):
    """Bitwise: arrays by dtype, shape and bytes; the rest by type and
    value."""
    if isinstance(x, np.ndarray):
        assert isinstance(y, np.ndarray)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.ascontiguousarray(x).tobytes() == \
            np.ascontiguousarray(y).tobytes()
    elif isinstance(x, dict):
        assert set(x) == set(y)
        for k in x:
            _assert_same(x[k], y[k])
    elif isinstance(x, (list, tuple)):
        assert type(x) is type(y) and len(x) == len(y)
        for a, b in zip(x, y):
            _assert_same(a, b)
    else:
        assert x == y and type(x) is type(y)


def _roundtrip(obj, wire, send=rpc.send_msg, recv=rpc.recv_msg):
    """Send ``obj`` through a socketpair; return the decoded object (the
    reader on a thread so a large payload cannot fill the socket buffer)."""
    a, b = socket.socketpair()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("msg", recv(b)))
    t.start()
    try:
        sent = send(a, obj, wire=wire)
    finally:
        t.join(WAIT_S)
        a.close()
        b.close()
    got, nbytes, got_wire = out["msg"]
    assert nbytes == sent and got_wire == wire
    return got


def _raw_frame(send, obj, wire):
    """The bytes ``send`` writes for ``obj``."""
    a, b = socket.socketpair()
    chunks = []

    def read():
        while True:
            c = b.recv(1 << 20)
            if not c:
                return
            chunks.append(c)

    t = threading.Thread(target=read)
    t.start()
    try:
        send(a, obj, wire=wire)
    finally:
        a.close()
        t.join(WAIT_S)
        b.close()
    return b"".join(chunks)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def test_framed_and_pickled_codecs_roundtrip_identical_payloads():
    payload = _payload(rpc)
    framed = _roundtrip(payload, "framed")
    pickled = _roundtrip(payload, "pickle")
    assert isinstance(framed[1]["grads"]["emb"], rpc.SparseGrad)
    _assert_same(_plain(framed), _plain(payload))
    _assert_same(_plain(pickled), _plain(payload))
    # a 0-d array stays 0-d, a strided view arrives contiguous and equal
    assert framed[1]["grads"]["scalar0d"].shape == ()
    assert framed[1]["grads"]["noncontig"].flags.c_contiguous


def test_framed_wire_is_smaller_than_pickle_for_tensors_and_counts_bytes():
    big = {"w": np.ones((64, 1024), np.float32)}
    sizes = {w: len(_raw_frame(rpc.send_msg, big, w))
             for w in ("framed", "pickle")}
    # framing overhead over the raw 256 KiB of tensor bytes is tiny
    assert sizes["framed"] < big["w"].nbytes + 512
    assert sizes["framed"] <= sizes["pickle"]
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=rpc.recv_msg, args=(b,))
        t.start()
        assert rpc.send_msg(a, big) == sizes["framed"]
        t.join(WAIT_S)
    finally:
        a.close()
        b.close()


class _Echo:
    def echo(self, x):
        return x

    def push(self, w):
        return int(np.asarray(w).size)

    def pull(self):
        return {"w": np.zeros((32, 8), np.float32)}

    def whose_trace(self):
        return current_trace_id()


def test_server_answers_in_the_request_codec():
    """A framed and a pickle client share one server; each reply comes back
    in the codec of its request."""
    srv = rpc.RpcServer(_Echo())
    srv.serve_in_thread()
    try:
        x = np.arange(6, dtype=np.float32)
        for wire in ("framed", "pickle"):
            s = socket.create_connection(srv.address, timeout=WAIT_S)
            try:
                rpc._client_handshake(s)
                rpc.send_msg(s, ("echo", {"x": x}), wire)
                (ok, got), _, got_wire = rpc.recv_msg(s)
            finally:
                s.close()
            assert ok and got_wire == wire
            _assert_same(got, x)
            c = rpc.RpcClient(srv.address, wire=wire)
            try:
                _assert_same(c.call("echo", x=x), x)
            finally:
                c.close()
        with pytest.raises(ValueError, match="unknown wire codec"):
            rpc.RpcClient(srv.address, wire="json")
    finally:
        srv.shutdown()


def test_torch_objects_are_refused_on_the_wire():
    """The codec is numpy-only on both codecs: a tensor, a device or a
    torch.Size raises before a byte is written."""
    import torch
    a, b = socket.socketpair()
    try:
        for bad in (torch.zeros(2), torch.device("cpu"), torch.Size([2])):
            for wire in ("framed", "pickle"):
                with pytest.raises(TypeError, match="numpy-only"):
                    rpc.send_msg(a, {"v": [bad]}, wire)
        b.setblocking(False)
        with pytest.raises(BlockingIOError):
            b.recv(1)                  # nothing was sent
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["framed", "pickle"])
def test_a_frame_is_the_same_bytes_from_either_package(wire):
    msg = ("infer", {"feed": {"x": np.arange(12, dtype=np.float32)
                              .reshape(3, 4)}, "model": None},
           {"trace": "0123456789abcdef"})
    assert _raw_frame(rpc.send_msg, msg, wire) == \
        _raw_frame(jrpc.send_msg, msg, wire)
    p_port, p_ref = _payload(rpc), _payload(jrpc)
    assert _raw_frame(rpc.send_msg, p_port, wire) == \
        _raw_frame(jrpc.send_msg, p_ref, wire)


@pytest.mark.parametrize("wire", ["framed", "pickle"])
def test_a_port_frame_decodes_in_the_reference(wire):
    got = _roundtrip(_payload(rpc), wire, send=rpc.send_msg,
                     recv=jrpc.recv_msg)
    # the reference builds its OWN classes from the port's frame
    assert type(got[1]["grads"]["emb"]) is jrpc.SparseGrad
    _assert_same(_plain(got), _plain(_payload(rpc)))


_DECODE_BLOCKED = r"""
import pickle, socket, sys, threading
sys.modules["paddle_tpu"] = None          # importing it now raises
jax_before = "jax" in sys.modules
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch.distributed import rpc
data = open(sys.argv[2], "rb").read()
a, b = socket.socketpair()
t = threading.Thread(target=lambda: (a.sendall(data), a.close()))
t.start()
obj, nbytes, wire = rpc.recv_msg(b)
t.join(10)
assert nbytes == len(data), (nbytes, len(data))
loaded = sorted(m for m in sys.modules
                if m.startswith("paddle_tpu.") and sys.modules[m] is not None)
assert not loaded, loaded
assert ("jax" in sys.modules) == jax_before, "decoding imported jax"

def plain(x):
    if isinstance(x, rpc.SparseGrad):
        return ("SparseGrad", x.rows, x.values, x.nrows, x.merged)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    return x

with open(sys.argv[3], "wb") as f:
    pickle.dump((wire, plain(obj)), f)
"""


@pytest.mark.parametrize("wire", ["framed", "pickle"])
def test_a_reference_frame_decodes_where_paddle_tpu_cannot_import(
        tmp_path, wire):
    """The reference's frame names ``paddle_tpu.distributed.rpc`` classes;
    the port decodes it in a process where that package cannot be
    imported, bitwise on every array."""
    payload = _payload(jrpc)
    frame = tmp_path / "frame.bin"
    frame.write_bytes(_raw_frame(jrpc.send_msg, payload, wire))
    script = tmp_path / "decode.py"
    script.write_text(_DECODE_BLOCKED)
    out = tmp_path / "decoded.pkl"
    r = subprocess.run([sys.executable, str(script), REPO, str(frame),
                        str(out)], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out, "rb") as f:
        got_wire, got = pickle.load(f)
    assert got_wire == wire
    _assert_same(got, _plain(payload))


def test_a_frame_naming_other_reference_classes_is_refused():
    """Only the reference's wire classes map: any other paddle_tpu name is
    refused rather than imported."""
    evil = pickle.dumps(jrpc.RetryPolicy())      # names paddle_tpu...rpc
    data = rpc._PREFIX.pack(b"P", 1, 0) + rpc._FLEN.pack(len(evil)) + evil
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        with pytest.raises(pickle.UnpicklingError, match="never imports"):
            rpc.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_sparse_grad_from_port_sparse_rows_drops_sentinels():
    import torch
    from paddle_tpu_torch.core.sparse import SparseRows
    sr = SparseRows(torch.tensor([2, 7, 0, 7]),
                    torch.arange(8, dtype=torch.bfloat16).reshape(4, 2),
                    nrows=7)
    sg = rpc.SparseGrad.from_sparse_rows(sr)
    np.testing.assert_array_equal(sg.rows, [2, 0])
    assert sg.values.dtype == np.float32 and sg.nrows == 7
    np.testing.assert_array_equal(sg.values, [[0, 1], [4, 5]])
    dense = sg.to_dense()
    assert dense.shape == (7, 2) and dense[2, 1] == 1.0


# ---------------------------------------------------------------------------
# timeouts, accounting, spans, trace ids
# ---------------------------------------------------------------------------

def test_rpc_timeout_flag_threads_through_clients():
    old = flags.get_flag("rpc_timeout_s")
    try:
        flags.set_flags({"rpc_timeout_s": 0.5})
        assert rpc.RpcClient(("127.0.0.1", 1))._timeout == 0.5
        # explicit override still wins
        assert rpc.RpcClient(("127.0.0.1", 1), timeout=2.0)._timeout == 2.0
    finally:
        flags.set_flags({"rpc_timeout_s": old})
    assert flags.get_flag("rpc_timeout_s") == 90.0       # the reference's


def test_rpc_timeout_flag_bounds_a_stuck_call():
    release = threading.Event()

    class Stuck:
        def hang(self):
            release.wait(GATE_S)

    srv = rpc.RpcServer(Stuck())
    srv.serve_in_thread()
    old = flags.get_flag("rpc_timeout_s")
    try:
        flags.set_flags({"rpc_timeout_s": 0.3})
        c = rpc.RpcClient(srv.address)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            c.call("hang")
        assert time.monotonic() - t0 < 2.0
        c.close()
    finally:
        flags.set_flags({"rpc_timeout_s": old})
        release.set()
        srv.kill()


def test_wire_counters_surface_in_server_stats_and_client():
    srv = rpc.RpcServer(_Echo())
    srv.serve_in_thread()
    c = rpc.RpcClient(srv.address)
    try:
        assert c.call("push", w=np.ones((32, 8), np.float32)) == 256
        c.call("pull")
        # the server notes a call after sending its reply, so its count
        # can land a beat after the client returns
        assert _wait_until(
            lambda: "pull" in srv.wire_stats.snapshot()["calls"])
        st = srv.wire_stats.snapshot()
        assert st["bytes_recv"] > 32 * 8 * 4           # saw the push
        assert st["bytes_sent"] > 32 * 8 * 4           # sent the pull
        assert st["calls"]["push"]["count"] == 1
        assert st["calls"]["pull"]["count"] == 1
        cs = c.wire_stats.snapshot()
        assert cs["bytes_sent"] > 32 * 8 * 4
        assert cs["calls"]["pull"]["count"] == 1
        assert cs["calls"]["pull"]["total_s"] > 0
        # the built-in scrape surfaces answer on every server
        snap = c.call("metrics")
        assert "paddle_tpu_wire_bytes_sent" in snap
        assert set(c.call("flight_dump")) >= {"events", "pid"}
    finally:
        c.close()
        srv.shutdown()


def test_rpc_calls_record_profiler_spans_and_carry_trace_ids():
    srv = rpc.RpcServer(_Echo())
    srv.serve_in_thread()
    c = rpc.RpcClient(srv.address)
    profiler.enable_profiler()
    try:
        c.call("push", w=np.ones(4, np.float32))
        c.call("pull")
        with trace_context("feedfacecafebeef"):
            assert c.call("whose_trace") == "feedfacecafebeef"
        # outside a context every call mints its own id
        assert len(c.call("whose_trace")) == 16
    finally:
        rows = profiler.disable_profiler(sorted_key="total")
        c.close()
        srv.shutdown()
    names = {r["name"] for r in rows}
    assert {"rpc.client/push", "rpc.client/pull",
            "rpc.serve/push", "rpc.serve/pull"} <= names


def test_remote_errors_are_structured_and_retry_is_bounded():
    class Boom:
        def fail(self):
            raise KeyError("nope")

    srv = rpc.RpcServer(Boom())
    srv.serve_in_thread()
    try:
        c = rpc.RpcClient(srv.address)
        with pytest.raises(rpc.RemoteError) as ei:
            c.call("fail")
        assert ei.value.code == "KeyError" and "nope" in str(ei.value)
        assert "remote traceback" in str(ei.value)
        c.close()
    finally:
        srv.kill()
    legacy = rpc.RemoteError.from_payload("m", "ValueError: bad")
    assert legacy.code == "ValueError" and legacy.remote_message == "bad"
    pol = rpc.RetryPolicy(max_retries=3, backoff_base_s=0.1,
                          backoff_max_s=0.3, jitter=0.25)
    for k, base in ((1, 0.1), (2, 0.2), (3, 0.3), (9, 0.3)):
        assert base <= pol.delay_s(k) <= base * 1.25
    # a dead address: the retry budget runs out, typed
    dead = rpc.RpcClient(srv.address, timeout=1.0,
                         retry=rpc.RetryPolicy(max_retries=2,
                                               backoff_base_s=0.01))
    with pytest.raises((ConnectionError, OSError)):
        dead.call("fail")
    dead.close()


def test_fault_plan_drop_response_applies_once_then_client_retries():
    """A reply lost after the call applied: the retrying client resends and
    the handler sees the call twice (the reason only idempotent surfaces
    retry)."""
    calls = []

    class Counter:
        def bump(self):
            calls.append(1)
            return len(calls)

    plan = FaultPlan().drop_response("bump", 0)
    srv = rpc.RpcServer(Counter(), fault_plan=plan)
    srv.serve_in_thread()
    try:
        c = rpc.RpcClient(srv.address, retry=rpc.RetryPolicy(
            max_retries=3, backoff_base_s=0.01))
        assert c.call("bump") == 2
        assert plan.wait("bump", 0, timeout=WAIT_S)
        c.close()
    finally:
        srv.kill()


# ---------------------------------------------------------------------------
# streaming responses (test_generation_serving.py:341-441)
# ---------------------------------------------------------------------------

class _StreamHandler:
    def __init__(self):
        self.closed_early = threading.Event()

    def count(self, n, fail_at=None, width=4, exc=RuntimeError):
        def gen():
            try:
                for i in range(int(n)):
                    if fail_at is not None and i == fail_at:
                        raise exc(f"boom at {i}")
                    yield {"i": i, "arr": np.full((width,), i, np.float32)}
            except GeneratorExit:
                self.closed_early.set()
                raise
        return gen()

    def unary(self, x):
        return x + 1


def test_rpc_streaming_frames_and_midstream_error():
    h = _StreamHandler()
    server = rpc.RpcServer(h)
    server.serve_in_thread()
    try:
        c = rpc.RpcClient(server.address)
        items = list(c.stream("count", n=4))
        assert [it["i"] for it in items] == [0, 1, 2, 3]
        np.testing.assert_array_equal(items[2]["arr"],
                                      np.full((4,), 2, np.float32))
        # the same connection serves unary calls after a clean stream
        assert c.call("unary", x=4) == 5
        got = []
        with pytest.raises(rpc.RemoteError) as ei:
            for it in c.stream("count", n=4, fail_at=2):
                got.append(it["i"])
        assert got == [0, 1] and ei.value.code == "RuntimeError"
        assert "boom at 2" in ei.value.remote_message
        # an OSError from the handler's own code is a remote failure owed
        # its error frame, not a vanished client
        with pytest.raises(rpc.RemoteError) as ei:
            list(c.stream("count", n=4, fail_at=1, exc=OSError))
        assert ei.value.code == "OSError"
        assert c.call("unary", x=1) == 2
        c.close()
    finally:
        server.kill()


def test_rpc_stream_abandon_cancels_the_handler_generator():
    h = _StreamHandler()
    server = rpc.RpcServer(h)
    server.serve_in_thread()
    try:
        c = rpc.RpcClient(server.address)
        # enough frames that the server cannot outrun the socket buffers:
        # it is still streaming when the client abandons
        s = c.stream("count", n=1_000_000, width=512)
        assert next(s)["i"] == 0
        s.close()
        assert h.closed_early.wait(WAIT_S), \
            "server generator was never closed"
        # the abandoned stream dropped the connection; the client reconnects
        assert c.call("unary", x=0) == 1
        c.close()
    finally:
        server.kill()


def test_rpc_unary_call_on_streaming_method_raises_typed():
    server = rpc.RpcServer(_StreamHandler())
    server.serve_in_thread()
    try:
        c = rpc.RpcClient(server.address)
        with pytest.raises(RuntimeError, match="stream"):
            c.call("count", n=3)
        # stream() on a unary method degrades to a one-item stream
        assert list(c.stream("unary", x=1)) == [2]
        c.close()
    finally:
        server.kill()


def test_port_client_streams_from_a_reference_server():
    """Streaming frames cross the packages too: the reference's RpcServer
    streams to the port's RpcClient."""
    server = jrpc.RpcServer(_StreamHandler())
    server.serve_in_thread()
    try:
        c = rpc.RpcClient(server.address)
        items = list(c.stream("count", n=3))
        assert [it["i"] for it in items] == [0, 1, 2]
        np.testing.assert_array_equal(items[1]["arr"],
                                      np.full((4,), 1, np.float32))
        c.close()
    finally:
        server.kill()
