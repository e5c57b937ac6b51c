"""The port's generative ModelServer and GenClient on the CPU, held to the
reference's on one bundle (the reference tests' tiny LM: vocab 17, emb 8, 2
heads, 2 layers, saved by the reference package).

Counterparts of tests/test_generation_serving.py:443-500: generate streams
over the wire, overload is typed across the wire, ``batching=False`` is
rejected. Across packages: greedy tokens from the port's GenClient against
the port's server equal the reference's GenClient against the reference's
server, and each package's client streams from the other's server. Within
the port: the token-batch frames (``TokenStream.batches``), a reload that
hands the wait queue to the new scheduler (``transfer_queued``), and a
stream abandoned mid-way that frees its slot.

Every wait is bounded and every server is closed in a ``finally``.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.serving import (GenClient as JGenClient,
                                ModelServer as JModelServer)
from paddle_tpu.testing.models import export_tiny_lm
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.distributed import RemoteError
from paddle_tpu_torch.serving import (ContinuousBatcher, GenClient,
                                      GenerationEngine, ModelServer,
                                      ServerOverloaded)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CPU = tfluid.CPUPlace()
WAIT_S = 5.0
VOCAB = 17
GEN_OPTS = dict(max_seqs=4, block_size=4, num_blocks=64, max_len=32,
                prefill_buckets=(8,))
PROMPTS = ([1, 2, 3], [4], [5, 6, 7, 8, 9], [16, 0])


def _wait_until(pred, timeout=WAIT_S):
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        tick.wait(0.005)
    return True


@pytest.fixture(scope="module")
def lm_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_genserve") / "model")
    export_tiny_lm(d, vocab=VOCAB, emb=8, heads=2, n_layers=2, max_pos=64,
                   seed=3)
    return d


def _gen_server(model_dir, **kw):
    kw.setdefault("model_kind", "generative")
    kw.setdefault("gen_opts", GEN_OPTS)
    kw.setdefault("engine", GenerationEngine(model_dir, place=CPU,
                                             **kw["gen_opts"]))
    server = ModelServer(model_dir, **kw)
    server.start()
    return server


def _reference_greedy(bundle_dir, prompt, max_new):
    """Full-window teacher-forced argmax decode through the ORIGINAL saved
    program on the reference executor (test_generation_serving.py:141)."""
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    program, feeds, fetches = jfluid.io.load_inference_model(
        bundle_dir, exe, scope=scope)
    toks, out = list(prompt), []
    for _ in range(max_new):
        T = len(toks)
        feed = {"tokens": np.asarray(toks, np.int64).reshape(1, T, 1),
                "positions": np.arange(T, dtype=np.int64).reshape(1, T, 1)}
        lg = exe.run(program, feed=feed, fetch_list=fetches, scope=scope)[0]
        t = int(np.argmax(np.asarray(lg)[0, -1]))
        out.append(t)
        toks.append(t)
    return out


def test_generate_streams_over_the_wire(lm_bundle):
    server = _gen_server(lm_bundle)
    try:
        with GenClient(server.address) as c:
            toks = list(c.generate([1, 2, 3], 6))
            assert toks == _reference_greedy(lm_bundle, [1, 2, 3], 6)
            beam = list(c.generate([1, 2, 3], 4,
                                   {"mode": "beam", "beam_size": 2}))
            assert len(beam) == 4
            health = c.health()
            assert health["model_kind"] == "generative" and health["warmed"]
            st = c.stats()
            assert st["engine"]["hot_recompiles"] == 0
            assert st["engine"]["active_sequences"] == 0
            assert st["batcher"]["tokens_emitted"] >= 10
            assert st["latency"]["count"] == 2       # time to first frame
            # the feed-forward surface is closed off, typed
            with pytest.raises(RemoteError, match="GENERATIVE"):
                c._rpc.call("infer", feed={"x": np.zeros((1, 2))})
    finally:
        assert server.shutdown()


def test_greedy_tokens_equal_across_packages(lm_bundle):
    """The port's GenClient against the port's server, the reference's
    against the reference's, and each client against the other package's
    server: the same greedy tokens for every prompt."""
    port_srv = _gen_server(lm_bundle)
    ref_srv = JModelServer(lm_bundle, model_kind="generative",
                           gen_opts=GEN_OPTS)
    ref_srv.start()
    try:
        got = {}
        for key, cls, addr in (("port", GenClient, port_srv.address),
                               ("ref", JGenClient, ref_srv.address),
                               ("port->ref", GenClient, ref_srv.address),
                               ("ref->port", JGenClient, port_srv.address)):
            with cls(addr) as c:
                got[key] = [list(c.generate(p, 7)) for p in PROMPTS]
        assert got["port"] == got["ref"] == got["port->ref"] \
            == got["ref->port"]
        assert all(len(t) == 7 for t in got["port"])
    finally:
        assert port_srv.shutdown()
        ref_srv.shutdown()


def test_concurrent_streams_each_get_their_own_tokens(lm_bundle):
    server = _gen_server(lm_bundle)
    want = [_reference_greedy(lm_bundle, p, 5) for p in PROMPTS]
    got = [None] * len(PROMPTS)
    start = threading.Barrier(len(PROMPTS))

    def client(i):
        start.wait(WAIT_S)
        with GenClient(server.address) as c:
            got[i] = list(c.generate(PROMPTS[i], 5))

    ts = [threading.Thread(target=client, args=(i,))
          for i in range(len(PROMPTS))]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S * 2)
        assert got == want
        st = server.stats()["batcher"]
        assert st["requests"] == len(PROMPTS) and st["in_flight"] == 0
    finally:
        assert server.shutdown()


def test_generate_overload_is_typed_across_the_wire(lm_bundle):
    server = _gen_server(
        lm_bundle, queue_capacity=1,
        gen_opts=dict(GEN_OPTS, max_seqs=1))
    c1, c2, c3 = (GenClient(server.address) for _ in range(3))
    g2_out = []
    t2 = threading.Thread(target=lambda: g2_out.extend(c2.generate([3], 3)))
    g1 = c1.generate([1, 2], 25)
    try:
        next(g1)                     # the one slot is taken
        t2.start()                   # queued behind g1 (capacity 1)
        assert _wait_until(
            lambda: server.batcher.stats()["queue_depth"] == 1)
        with pytest.raises(ServerOverloaded):
            list(c3.generate([4], 3))
        assert len(list(g1)) == 24   # 25 minus the one consumed
        t2.join(WAIT_S * 2)
        assert g2_out == _reference_greedy(lm_bundle, [3], 3)
    finally:
        g1.close()                   # a live stream holds its client
        if t2.is_alive():
            t2.join(WAIT_S)
        for c in (c1, c2, c3):
            c.close()
        server.shutdown()


def test_generative_server_rejects_batching_false(lm_bundle):
    with pytest.raises(ValueError, match="batching=False"):
        ModelServer(lm_bundle, model_kind="generative", batching=False,
                    gen_opts=GEN_OPTS,
                    engine=GenerationEngine(lm_bundle, place=CPU, **GEN_OPTS))


def test_abandoned_stream_frees_its_slot(lm_bundle):
    server = _gen_server(lm_bundle, gen_opts=dict(GEN_OPTS, max_seqs=1))
    try:
        with GenClient(server.address) as c:
            g = c.generate([1, 2], 25)
            assert next(g) == _reference_greedy(lm_bundle, [1, 2], 1)[0]
            g.close()                # the client drops the connection
        assert _wait_until(
            lambda: server.engine.stats()["active_sequences"] == 0)
        with GenClient(server.address) as c:
            assert list(c.generate([4], 3)) == \
                _reference_greedy(lm_bundle, [4], 3)
    finally:
        assert server.shutdown()


def test_reload_hands_the_wait_queue_to_the_new_engine(lm_bundle, tmp_path):
    """A generative reload: the in-flight stream finishes on the old engine,
    the queued one moves to the new scheduler (transfer_queued) instead of
    being rejected, and both callers get their full greedy tokens. The new
    version is the bundle with the VERSION.json a registry version carries
    (``model_kind`` generative: a plain export dir sniffs as
    feed-forward, which a generative server refuses to reload)."""
    import json
    import shutil
    v2 = tmp_path / "v2"
    shutil.copytree(lm_bundle, v2)
    (v2 / "VERSION.json").write_text(json.dumps({"model_kind":
                                                 "generative"}))
    plain = ModelServer(lm_bundle, model_kind="generative",
                        gen_opts=GEN_OPTS, engine=GenerationEngine(
                            lm_bundle, place=CPU, **GEN_OPTS))
    try:
        with pytest.raises(ValueError,
                           match="cannot reload a 'feedforward'"):
            plain.reload(lm_bundle)
    finally:
        assert plain.shutdown()
    server = _gen_server(lm_bundle, gen_opts=dict(GEN_OPTS, max_seqs=1))
    # the in-flight request must outlast the reload: each old-engine step
    # waits 50 ms first, so its 12 tokens take >= 0.6 s however busy the
    # host is (on a loaded host the reload lost that race now and then)
    old_engine = server.engine
    step = old_engine.step
    old_engine.step = lambda: (time.sleep(0.05), step())[1]
    c1, c2 = GenClient(server.address), GenClient(server.address)
    out2 = []
    t2 = threading.Thread(target=lambda: out2.extend(c2.generate([4], 5)))
    g1 = c1.generate([1, 2], 12)
    try:
        first = next(g1)
        t2.start()
        assert _wait_until(
            lambda: server.batcher.stats()["queue_depth"] == 1)
        res = server.reload(str(v2), version=2)
        assert res["requeued"] == 1 and res["version"] == 2
        assert server.engine is not old_engine
        rest = list(g1)
        t2.join(WAIT_S * 2)
        assert [first] + rest == _reference_greedy(lm_bundle, [1, 2], 12)
        assert out2 == _reference_greedy(lm_bundle, [4], 5)
        assert server.health()["version"] == 2
    finally:
        g1.close()                   # a live stream holds its client
        t2.join(WAIT_S)
        c1.close()
        c2.close()
        assert server.shutdown()


def test_token_stream_batches_coalesce_queued_tokens(lm_bundle):
    """TokenStream.batches yields what is queued as one list per wait, ends
    at the stream's end, and re-raises a worker error after the tokens
    before it."""
    eng = GenerationEngine(lm_bundle, place=CPU, **GEN_OPTS)
    eng.warmup()
    b = ContinuousBatcher(eng)
    try:
        s = b.submit([1, 2, 3], 6)
        frames = list(s.batches())
        assert sum(frames, []) == _reference_greedy(lm_bundle, [1, 2, 3], 6)
        assert all(frames)
        # a stream the worker fails: the queued tokens, then the error
        s2 = b.submit([1], 2)
        s2._emit([7, 8])
        s2._finish(RuntimeError("worker failed"))
        with pytest.raises(RuntimeError, match="worker failed"):
            seen = []
            for batch in s2.batches():
                seen.append(batch)
        assert seen and seen[0][:2] == [7, 8]
    finally:
        assert b.close(WAIT_S)


def test_transfer_queued_into_a_closed_batcher_rejects_typed(lm_bundle):
    eng = GenerationEngine(lm_bundle, place=CPU,
                           **dict(GEN_OPTS, max_seqs=1))
    eng.warmup()
    old = ContinuousBatcher(eng)
    new = ContinuousBatcher(eng)
    try:
        s1 = old.submit([1, 2], 20)
        it1 = iter(s1)
        next(it1)                    # s1 holds the one slot
        s2 = old.submit([3], 2)
        assert _wait_until(lambda: old.stats()["queue_depth"] == 1)
        assert new.close(WAIT_S)
        assert old.transfer_queued(new) == 0
        with pytest.raises(RuntimeError, match="rejected without"):
            list(s2)
        s1.close()
    finally:
        old.close(WAIT_S)
