"""The port's ModelServer, InferClient and GenClient (paddle_tpu_torch/
serving/) on the CPU, held to the reference's on the same bundles.

Counterparts of tests/test_serving.py:368-520 (end to end with health and
stats, overload typed across the wire, graceful drain, a client retrying
through a kill and restart) and of tests/test_serving_multitenant.py:60-210,
248-296 and 369-425 (two models on one server bitwise equal to two solo
servers, a generative model beside the default, LRU eviction that never
takes an in-flight model, a reload leaving the other model alone, both
typed wire codes, the queue-depth gauge). The bundles are saved by the
reference package; the port serves them on engines built with
``place=CPUPlace()``.

Across packages: one narrow-ResNet bundle is served by the reference's
ModelServer (JAX on the CPU) and by the port's; a port InferClient calls
the reference server and a reference InferClient calls the port's, and the
replies agree within ``TOL``. Typed errors cross both ways by their codes.

Every wait is bounded, servers bind port 0 and close in a ``finally``, and
requests are held on events instead of sleeps.
"""

import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import io as jio
from paddle_tpu.serving import (InferClient as JInferClient,
                                ModelServer as JModelServer,
                                QuotaExceeded as JQuotaExceeded,
                                ServerOverloaded as JServerOverloaded)
from paddle_tpu.testing.models import export_tiny_lm
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.distributed import FaultPlan, RemoteError, RetryPolicy
from paddle_tpu_torch.obs.metrics import REGISTRY
from paddle_tpu_torch.obs.slo import SloRule
from paddle_tpu_torch.serving import (DynamicBatcher, GenClient,
                                      GenerationEngine, InferClient,
                                      InferenceEngine, ModelServer,
                                      QuotaExceeded, ServerOverloaded,
                                      TenantQuotas)
from paddle_tpu_torch.serving.server import sniff_model_kind
from paddle_tpu_torch.testing.models import resnet

CPU = tfluid.CPUPlace()
WAIT_S = 5.0
# the bound on a held dispatch, released by the test well before it
GATE_S = 10.0
# float32 replies of two packages that order their sums differently (the
# MLP's two GEMMs; the narrow ResNet's 17 convs): float32 roundings, as
# tests/test_torch_serving.py holds the engines
TOL = dict(rtol=1e-4, atol=1e-5)
GEN_OPTS = dict(max_seqs=4, block_size=4, num_blocks=64, max_len=32,
                prefill_buckets=(8,))


def _wait_until(pred, timeout=WAIT_S):
    tick = threading.Event()
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        tick.wait(0.005)
    return True


def _assert_plain_json(obj):
    """Builtins only, all the way down (dict keys may be ints, as
    json_safe leaves them), and json.dumps takes it."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            assert type(k) in (str, int), (k, type(k))
            _assert_plain_json(v)
    elif isinstance(obj, list):
        for v in obj:
            _assert_plain_json(v)
    else:
        assert obj is None or type(obj) in (str, int, float, bool), \
            (obj, type(obj))
    json.dumps(obj)


def _export_mlp(d, weight_shift=0.0, dim=6, hidden=8, classes=3, n=16):
    """The reference tests' tiny MLP, saved by the reference package;
    ``weight_shift`` perturbs the parameters so two exports differ.
    Returns (dir, inputs, the reference executor's outputs)."""
    from paddle_tpu.fluid import framework as jframework
    jframework.reset_unique_name()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", shape=[dim])
        h = jfluid.layers.fc(input=x, size=hidden, act="relu")
        y = jfluid.layers.fc(input=h, size=classes, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    if weight_shift:
        for p in main.all_parameters():
            v = np.asarray(scope.find_var(p.name))
            scope.set(p.name, v + np.float32(weight_shift))
    jio.save_inference_model(str(d), ["x"], [y], exe, main, scope=scope)
    xs = np.random.RandomState(0).normal(0, 1, (n, dim)).astype("float32")
    want = exe.run(main, feed={"x": xs}, fetch_list=[y], scope=scope)[0]
    return str(d), xs, np.asarray(want)


@pytest.fixture(scope="module")
def mlps(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_server_mlps")
    return {name: _export_mlp(root / name, shift)
            for name, shift in (("a", 0.0), ("b", 0.1), ("b2", 0.7),
                                ("c", 0.2), ("d", 0.3))}


@pytest.fixture(scope="module")
def lm_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_server_lm") / "lm")
    export_tiny_lm(d, vocab=13, emb=8, heads=2, n_layers=2, max_pos=64,
                   seed=3)
    return d


def _server(d, **kw):
    """A ModelServer over ``d`` whose default engine runs on the CPU (the
    engines it builds later follow that engine's device)."""
    if kw.get("model_kind") == "generative":
        eng = GenerationEngine(d, place=CPU, **kw.get("gen_opts", {}))
    else:
        eng = InferenceEngine(d, place=CPU, buckets=kw.pop("buckets", None))
    return ModelServer(d, engine=eng, **kw)


def _slow_engine(d, buckets, gate, started=None):
    """An engine whose infer waits on ``gate`` (bounded)."""
    eng = InferenceEngine(d, place=CPU, buckets=buckets)
    inner = eng.infer

    def slow_infer(feed, fetch_list=None):
        if started is not None:
            started.set()
        gate.wait(GATE_S)
        return inner(feed, fetch_list)

    eng.infer = slow_infer
    return eng


# ---------------------------------------------------------------------------
# ModelServer + InferClient end to end (test_serving.py:368-520)
# ---------------------------------------------------------------------------

def test_server_end_to_end_with_health_and_stats(mlps):
    d, xs, want = mlps["a"]
    server = _server(d, buckets="1,2,4,8", max_delay_ms=2.0)
    server.start()
    try:
        with InferClient(server.address) as c:
            h = c.health()
            assert h["status"] == "serving" and h["warmed"] and h["batching"]
            assert h["memory"]["sources"] == {"cpu:0": "process_rss"}
            out = c.infer({"x": xs[:5]})
            np.testing.assert_allclose(out[0], want[:5], **TOL)
            results = {}

            def one(i):
                with InferClient(server.address) as cc:
                    results[i] = cc.infer({"x": xs[i:i + 1]})[0]

            ts = [threading.Thread(target=one, args=(i,)) for i in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(WAIT_S)
            for i in range(8):
                np.testing.assert_allclose(results[i], want[i:i + 1], **TOL)
            st = c.stats()
            # health and stats are plain JSON: builtins only
            _assert_plain_json(st)
            _assert_plain_json(h)
            assert st["engine"]["hot_recompiles"] == 0
            assert st["engine"]["warmed"]
            assert st["engine"]["compiles"] == 4           # one per bucket
            assert st["latency"]["count"] == 9
            assert st["latency"]["p99_ms"] >= st["latency"]["p50_ms"] >= 0.0
            assert st["batcher"]["requests"] == 9
            assert st["wire"]["calls"]["infer"]["count"] == 9
            assert st["engine"]["kernel_tier"] == "torch"
    finally:
        assert server.shutdown() is True
    # a drained server is really closed: a no-retry client can't reach it
    dead = InferClient(server.address, retry=None, timeout=1.0)
    with pytest.raises((ConnectionError, EOFError, OSError, TimeoutError)):
        dead.infer({"x": xs[:1]})
    dead.close()


@pytest.mark.parametrize("batching", [True, False])
def test_both_wire_codecs_and_batching_modes_answer_alike(mlps, batching):
    d, xs, want = mlps["a"]
    server = _server(d, buckets="1,2,4", batching=batching, max_delay_ms=1.0)
    server.start()
    try:
        got = {}
        for wire in ("framed", "pickle"):
            with InferClient(server.address, wire=wire) as c:
                got[wire] = c.infer({"x": xs[:3]})[0]
        assert np.array_equal(got["framed"], got["pickle"])
        np.testing.assert_allclose(got["framed"], want[:3], **TOL)
        st = server.stats()
        assert ("batcher" in st) == batching
        assert st["engine"]["dispatches"] == 3 + 2     # warmup + 2 requests
    finally:
        server.shutdown()


def test_server_overload_is_typed_across_the_wire(mlps):
    d, xs, _ = mlps["a"]
    release = threading.Event()
    server = ModelServer(engine=_slow_engine(d, "1,2", release),
                         batching=True, queue_capacity=1, max_delay_ms=1.0)
    server.start()
    outcomes = []

    def caller(i):
        with InferClient(server.address, retry=None) as c:
            try:
                c.infer({"x": xs[i:i + 1]})
                outcomes.append("ok")
            except ServerOverloaded:
                outcomes.append("overloaded")

    ts = [threading.Thread(target=caller, args=(i,)) for i in range(5)]
    try:
        for t in ts:
            t.start()
        assert _wait_until(lambda: outcomes.count("overloaded") >= 1)
        release.set()
        for t in ts:
            t.join(WAIT_S)
        # the rejection surfaced client-side as the typed ServerOverloaded
        # (not a bare RuntimeError), while admitted requests completed
        assert outcomes.count("overloaded") >= 1
        assert outcomes.count("ok") >= 1
        assert len(outcomes) == 5
    finally:
        release.set()
        server.shutdown()


def test_server_graceful_drain_answers_inflight(mlps):
    d, xs, want = mlps["a"]
    gate, started = threading.Event(), threading.Event()
    server = ModelServer(engine=_slow_engine(d, "1,2", gate, started),
                         batching=True, max_delay_ms=1.0)
    server.start()
    got = {}

    def request():
        with InferClient(server.address) as c:
            got["out"] = c.infer({"x": xs[:1]})

    t = threading.Thread(target=request)
    t.start()
    drained = []
    try:
        assert started.wait(WAIT_S)            # the request is mid-batch
        st = threading.Thread(
            target=lambda: drained.append(server.shutdown(drain=True,
                                                          timeout=10.0)))
        st.start()
        assert _wait_until(lambda: server._rpc._draining.is_set())
        gate.set()                             # now let it finish
        st.join(10.0)
        t.join(WAIT_S)
    finally:
        gate.set()
        if not drained:
            server.kill()
    assert drained == [True] and not t.is_alive()
    # the in-flight request was answered, not severed
    np.testing.assert_allclose(got["out"][0], want[:1], **TOL)


def test_kill_mid_request_client_retries_restarted_server(mlps):
    d, xs, want = mlps["a"]
    # the second infer request: the server dies before serving it
    plan = FaultPlan().die("infer", 1, before=True)
    server1 = _server(d, buckets="1,2,4", max_delay_ms=1.0, fault_plan=plan)
    server1.start()
    addr = server1.address
    restarted = []
    c = InferClient(addr, retry=RetryPolicy(max_retries=60,
                                            backoff_base_s=0.02,
                                            backoff_max_s=0.2))
    try:
        out = c.infer({"x": xs[:1]})           # infer #0 serves normally
        np.testing.assert_allclose(out[0], want[:1], **TOL)

        def restart():
            if plan.wait("infer", 1, timeout=WAIT_S):
                s2 = _server(d, buckets="1,2,4", max_delay_ms=1.0,
                             address=addr)      # same address, same model
                s2.start()
                restarted.append(s2)

        rt = threading.Thread(target=restart, daemon=True)
        rt.start()
        # infer #1 hits the crash: EOF mid-call, then reconnect-and-resend
        # against the restarted server (inference is idempotent)
        out2 = c.infer({"x": xs[1:3]})
        np.testing.assert_allclose(out2[0], want[1:3], **TOL)
        rt.join(WAIT_S)
        st = c.stats()
        assert st["engine"]["warmed"] and st["engine"]["hits"] >= 1
        assert restarted, "restart thread never brought the server back"
    finally:
        c.close()
        server1.kill()
        for s in restarted:
            s.shutdown()


def test_exec_cache_is_not_ported_and_says_so(mlps):
    with pytest.raises(NotImplementedError, match="execcache"):
        _server(mlps["a"][0], exec_cache="/tmp/nowhere")
    assert sniff_model_kind(mlps["a"][0]) == "feedforward"


def test_slo_rules_surface_in_health(mlps):
    d, xs, _ = mlps["a"]
    rule = SloRule("latency", "paddle_tpu_serving_request_seconds",
                   objective=1e6, windows=((1.0, 1.0),))
    server = _server(d, buckets="1,2", max_delay_ms=1.0,
                     slo_rules=[rule.to_dict()])
    server.start()
    try:
        with InferClient(server.address) as c:
            c.infer({"x": xs[:2]})
            server._slo_monitor.evaluate_once()
            h = c.health()
        assert h["slo"]["ok"] and "latency" in h["slo"]["rules"]
    finally:
        assert server.shutdown()
    assert server._slo_monitor is None


# ---------------------------------------------------------------------------
# multi-model hosting (test_serving_multitenant.py:60-210)
# ---------------------------------------------------------------------------

def test_two_models_one_server_bitwise_matches_two_solo_servers(mlps):
    dA, xs, _ = mlps["a"]
    dB = mlps["b"][0]
    soloA = _server(dA, buckets="1,2,4,8", max_delay_ms=1.0)
    soloB = _server(dB, buckets="1,2,4,8", max_delay_ms=1.0)
    multi = _server(dA, buckets="1,2,4,8", max_delay_ms=1.0)
    for s in (soloA, soloB, multi):
        s.start()
    try:
        added = multi.add_model("bee", model_dir=dB, buckets="1,2,4,8")
        assert added["model"] == "bee" and added["evicted"] == []
        with InferClient(soloA.address) as ca, \
                InferClient(soloB.address) as cb, \
                InferClient(multi.address) as cm:
            for n in (1, 3, 8):
                wantA = ca.infer({"x": xs[:n]})[0]
                wantB = cb.infer({"x": xs[:n]})[0]
                assert np.array_equal(cm.infer({"x": xs[:n]})[0], wantA)
                assert np.array_equal(
                    cm.infer({"x": xs[:n]}, model="bee")[0], wantB)
            np.testing.assert_allclose(wantB, mlps["b"][2][:8], **TOL)
            h = cm.health()
            assert h["models"]["bee"]["model_kind"] == "feedforward"
            assert h["models"]["bee"]["inflight"] == 0
            assert cm.stats()["models"]["bee"]["engine"]["hot_recompiles"] \
                == 0
            assert "models" not in ca.health()
            with pytest.raises(RemoteError, match="unknown model"):
                cm.infer({"x": xs[:1]}, model="nope")
    finally:
        assert multi.shutdown()
        soloA.shutdown()
        soloB.shutdown()


def test_generative_model_beside_feedforward_default(mlps, lm_bundle):
    dF, xs, _ = mlps["a"]
    solo = _server(lm_bundle, model_kind="generative", gen_opts=GEN_OPTS)
    multi = _server(dF, buckets="1,2,4", max_delay_ms=1.0)
    solo.start()
    multi.start()
    try:
        multi.add_model("lm", model_dir=lm_bundle, model_kind="generative",
                        gen_opts=GEN_OPTS)
        with GenClient(solo.address) as cs:
            want = list(cs.generate([1, 2, 3], 6))
        with GenClient(multi.address) as cg:
            got = list(cg.generate([1, 2, 3], 6, model="lm"))
        assert got == want and len(got) == 6
        with InferClient(multi.address) as ci:
            assert ci.infer({"x": xs[:2]})[0].shape == (2, 3)
            with pytest.raises(RemoteError, match="GENERATIVE"):
                ci.infer({"x": xs[:1]}, model="lm")
        h = multi.health()
        assert h["models"]["lm"]["model_kind"] == "generative"
        assert h["models"]["lm"]["warmed"]
    finally:
        assert multi.shutdown()
        solo.shutdown()


def test_lru_evicts_idle_never_inflight(mlps):
    xs = mlps["a"][1]
    srv = _server(mlps["a"][0], buckets="1,2", max_delay_ms=1.0,
                  max_models=3)            # default + 2 named slots
    srv.start()
    try:
        srv.add_model("b", model_dir=mlps["b"][0], buckets="1,2")
        srv.add_model("c", model_dir=mlps["c"][0], buckets="1,2")
        with InferClient(srv.address) as c:
            c.infer({"x": xs[:1]}, model="b")    # b now fresher than c
        out = srv.add_model("d", model_dir=mlps["d"][0], buckets="1,2")
        assert out["evicted"] == ["c"]           # LRU, not insertion order
        assert sorted(srv.health()["models"]) == ["b", "d"]
        hb, hd = srv._checkout("b"), srv._checkout("d")
        try:
            with pytest.raises(RuntimeError, match="in-flight"):
                srv.add_model("c", model_dir=mlps["c"][0], buckets="1,2")
        finally:
            srv._checkin(hb)
            srv._checkin(hd)
        out = srv.add_model("c", model_dir=mlps["c"][0], buckets="1,2")
        assert len(out["evicted"]) == 1
        hc = srv._checkout("c")
        with pytest.raises(RuntimeError, match="in-flight"):
            srv.remove_model("c")
        srv._checkin(hc)
        assert srv.remove_model("c")["removed"]
    finally:
        assert srv.shutdown()


def test_reload_one_model_leaves_the_other_untouched(mlps):
    dA, xs, _ = mlps["a"]
    srv = _server(dA, buckets="1,2,4", max_delay_ms=1.0)
    srv.start()
    try:
        srv.add_model("bee", model_dir=mlps["b"][0], buckets="1,2,4")
        with InferClient(srv.address) as c:
            before = c.infer({"x": xs[:2]})[0]
            engineA = srv.engine
            compilesA = srv.engine.stats()["compiles"]
            out = srv.reload(mlps["b2"][0], model="bee", version=2)
            assert out["model"] == "bee" and out["version"] == 2
            assert out["compiles"] == 3
            got = c.infer({"x": xs[:4]}, model="bee")[0]
            np.testing.assert_allclose(got, mlps["b2"][2][:4], **TOL)
            assert srv.engine is engineA
            assert srv.engine.stats()["compiles"] == compilesA
            assert srv.engine.stats()["hot_recompiles"] == 0
            assert np.array_equal(c.infer({"x": xs[:2]})[0], before)
            assert c.health()["models"]["bee"]["version"] == 2
            assert srv.stats()["models"]["bee"]["reloads"] == 1
            # the default model's own reload swaps its engine
            out = srv.reload(mlps["c"][0], version=7)
            assert out == {"version": 7, "compiles": 3}
            assert srv.engine is not engineA
            np.testing.assert_allclose(c.infer({"x": xs[:3]})[0],
                                       mlps["c"][2][:3], **TOL)
            assert c.stats()["reloads"] == 1
    finally:
        assert srv.shutdown()


def test_built_engines_follow_the_default_engine_device(mlps):
    """ModelServer takes no place=: the engines add_model and reload build
    run where the default engine runs (here the CPU; the card's default
    engine puts them on the card)."""
    import inspect
    assert "place" not in inspect.signature(ModelServer).parameters
    dA, xs, _ = mlps["a"]
    srv = _server(dA, buckets="1,2", max_delay_ms=1.0)
    srv.start()
    try:
        srv.add_model("bee", model_dir=mlps["b"][0], buckets="1,2")
        assert srv._models["bee"].engine.device.type == "cpu"
        srv.reload(mlps["b2"][0], model="bee")
        assert srv._models["bee"].engine.device.type == "cpu"
        srv.reload(mlps["c"][0])
        assert srv.engine.device.type == "cpu"
        with InferClient(srv.address) as c:
            np.testing.assert_allclose(c.infer({"x": xs[:2]})[0],
                                       mlps["c"][2][:2], **TOL)
    finally:
        assert srv.shutdown()


def test_both_wire_codes_roundtrip_typed(mlps):
    d, xs, _ = mlps["a"]
    release = threading.Event()
    srv = ModelServer(engine=_slow_engine(d, "1,2", release), batching=True,
                      queue_capacity=1, max_delay_ms=1.0,
                      tenant_quotas=TenantQuotas(rate=0.01, burst=1))
    srv.start()
    outcomes = []

    def caller(i):
        with InferClient(srv.address, retry=None) as c:
            try:
                c.infer({"x": xs[i:i + 1]})
                outcomes.append("ok")
            except ServerOverloaded:
                outcomes.append("overloaded")

    ts = [threading.Thread(target=caller, args=(i,)) for i in range(5)]
    try:
        for t in ts:
            t.start()
        assert _wait_until(lambda: outcomes.count("overloaded") >= 1)
        release.set()
        for t in ts:
            t.join(WAIT_S)
        with InferClient(srv.address, retry=None) as c:
            c.infer({"x": xs[:1]}, tenant="burst")       # spends the burst
            with pytest.raises(QuotaExceeded, match="quota"):
                c.infer({"x": xs[:1]}, tenant="burst")
            with pytest.raises(RemoteError, match="unknown model"):
                c.infer({"x": xs[:1]}, model="ghost")
        # the reference's client re-raises ITS types from the same codes
        with JInferClient(srv.address, retry=None) as jc:
            with pytest.raises(JQuotaExceeded, match="quota"):
                jc.infer({"x": xs[:1]}, tenant="burst")
        assert srv.stats()["quotas"]["tenants"]["burst"] == {
            "admitted": 1, "rejected": 2}
    finally:
        release.set()
        srv.shutdown()


def test_queue_depth_gauge_tracks_pending():
    gate, entered = threading.Event(), threading.Event()

    def run_batch(feed, fetch_list=None):
        entered.set()
        gate.wait(GATE_S)
        return [np.asarray(feed["x"])]

    b = DynamicBatcher(run_batch, max_batch=1, max_delay_ms=1.0, capacity=8)

    def depth():
        fam = REGISTRY.snapshot()["paddle_tpu_server_queue_depth"]
        for v in fam["values"]:
            if v["labels"]["instance"] == b.obs_instance:
                return v["value"]
        return None

    assert depth() == 0
    ts = [threading.Thread(target=lambda: b.submit({"x": np.zeros((1, 2))}))
          for _ in range(4)]
    try:
        for t in ts:
            t.start()
        assert entered.wait(WAIT_S)
        assert _wait_until(lambda: (depth() or 0) >= 1)
    finally:
        gate.set()
        for t in ts:
            t.join(WAIT_S)
    assert b.close(WAIT_S)
    assert depth() == 0


# ---------------------------------------------------------------------------
# serving across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_bundle(tmp_path_factory):
    """A narrow ResNet (stage depths 1,1,1,1, base 8, 32x32x3, 10 classes,
    softmax fetch) saved by the reference with seeded batch-norm
    statistics, as tests/test_torch_serving.py builds it."""
    from paddle_tpu.fluid import framework as jframework
    jframework.reset_unique_name()
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 11
    with jfluid.program_guard(main, startup):
        img = jfluid.layers.data("img", shape=[32, 32, 3])
        prob = jfluid.layers.softmax(resnet(img, 10, counts=(1, 1, 1, 1),
                                            base=8, layers=jfluid.layers))
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            c = np.asarray(scope.find_var(op.input("Scale")[0])).shape[0]
            for slot, v in (("Scale", rng.uniform(0.5, 1.5, c)),
                            ("Bias", rng.normal(0, 0.2, c)),
                            ("Mean", rng.normal(0, 0.2, c)),
                            ("Variance", rng.uniform(0.5, 2.0, c))):
                scope.set(op.input(slot)[0], v.astype("float32"))
    assert jfluid.fuse_conv_bn(main) == 17
    d = str(tmp_path_factory.mktemp("torch_server_resnet") / "resnet")
    jio.save_inference_model(d, ["img"], [prob], exe, main_program=main,
                             scope=scope)
    return d


def test_clients_and_servers_of_both_packages_agree(resnet_bundle):
    """Port client -> reference server and reference client -> port server,
    with the port's and the reference's in-process engines beside them."""
    imgs = np.random.RandomState(0).normal(
        0, 1, (5, 32, 32, 3)).astype("float32")
    port_srv = _server(resnet_bundle, buckets="1,2,4", max_delay_ms=1.0)
    ref_srv = JModelServer(resnet_bundle, buckets="1,2,4", max_delay_ms=1.0)
    port_srv.start()
    ref_srv.start()
    try:
        with InferClient(ref_srv.address) as pc, \
                JInferClient(port_srv.address) as jc, \
                InferClient(port_srv.address) as pp:
            for n in (1, 3, 5):
                feed = {"img": imgs[:n]}
                port_to_ref = pc.infer(feed)[0]
                ref_to_port = jc.infer(feed)[0]
                port_to_port = pp.infer(feed)[0]
                assert port_to_ref.shape == ref_to_port.shape == (n, 10)
                np.testing.assert_allclose(ref_to_port, port_to_ref, **TOL)
                # the wire changes nothing: the port server's reply is the
                # same bytes whichever package's client asked
                assert np.array_equal(ref_to_port, port_to_port)
                want = port_srv.engine.infer(feed)[0]
                assert np.array_equal(port_to_port, want)
            # health and stats decode in the other package as plain JSON
            for st in (jc.health(), jc.stats(), pc.health(), pc.stats()):
                _assert_plain_json(st)
            assert jc.stats()["engine"]["hot_recompiles"] == 0
            assert pc.stats()["engine"]["hot_recompiles"] == 0
    finally:
        assert port_srv.shutdown()
        ref_srv.shutdown()


def test_overload_crosses_packages_typed(mlps):
    """A port server's overload re-raises as the reference client's own
    ServerOverloaded, and a reference server's as the port client's."""
    d, xs, _ = mlps["a"]
    release = threading.Event()
    port_srv = ModelServer(engine=_slow_engine(d, "1", release),
                           batching=True, queue_capacity=1,
                           max_delay_ms=1.0)
    port_srv.start()
    seen = []

    def caller(i, cls, exc):
        with cls(port_srv.address, retry=None) as c:
            try:
                c.infer({"x": xs[i:i + 1]})
                seen.append("ok")
            except exc:
                seen.append("overloaded")

    ts = [threading.Thread(target=caller,
                           args=(i, JInferClient, JServerOverloaded))
          for i in range(4)]
    try:
        for t in ts:
            t.start()
        assert _wait_until(lambda: "overloaded" in seen)
    finally:
        release.set()
        for t in ts:
            t.join(WAIT_S)
        port_srv.shutdown()
    assert len(seen) == 4 and "ok" in seen
