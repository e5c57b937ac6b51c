"""The port's serving fleet control plane (paddle_tpu_torch/serving/
registry.py, router.py, fleet.py, autoscale.py) on the CPU: the counterpart
of tests/test_serving_fleet.py and the autoscaler's decisions.

* ModelRegistry: atomic versioned publish, immutability, typed errors, a
  torn publish stays invisible, ``verify`` catches bit rot, ``gc`` keeps
  the latest, its rollback target and pinned versions; the content hash
  equals the reference registry's on the same bundle files, and both
  packages' ``save_inference_model`` write the same bytes for one program
  and parameters;
* FleetClient over in-process servers: balancing, failover with ejection
  and probation re-admission, overload spillover;
* a server's hot reload;
* FleetAutoscaler's decisions on scripted fleet snapshots;
* one spawned fleet of 2 CPU replicas serving a tiny MLP, replies within
  1e-6 of the reference ModelServer's, through a rolling reload, a failed
  canary's rollback and a killed replica's rejoin.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.serving import (InferClient as JInferClient,
                                ModelRegistry as JModelRegistry,
                                ModelServer as JModelServer)
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.serving import (CanaryFailed, FleetAutoscaler,
                                      FleetClient, FleetSupervisor,
                                      InferClient, InferenceEngine,
                                      ModelRegistry, ModelServer,
                                      ServerOverloaded)

CPU = fluid.CPUPlace()
TOL = dict(rtol=1e-5, atol=1e-6)


def _build(fl, dim=6, hidden=8, classes=3):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", shape=[dim])
        h = fl.layers.fc(input=x, size=hidden, act="relu")
        y = fl.layers.fc(input=h, size=classes, act="softmax")
    return main, startup, y


def _export(tmp_path, name="A", shift=0.0, n=16):
    """A tiny MLP saved by the reference package (JAX on the CPU), whose
    parameters ``shift`` perturbs; returns (dir, inputs, its outputs)."""
    main, startup, y = _build(jfluid)
    exe = jfluid.Executor()
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    for p in main.all_parameters():
        scope.set(p.name, np.asarray(scope.find_var(p.name))
                  + np.float32(shift))
    d = str(tmp_path / name)
    jfluid.io.save_inference_model(d, ["x"], [y], exe, main, scope=scope)
    xs = np.random.RandomState(0).normal(0, 1, (n, 6)).astype("float32")
    want = exe.run(main, feed={"x": xs}, fetch_list=[y], scope=scope)[0]
    return d, xs, np.asarray(want)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fleet")
    return {"A": _export(root, "A"), "B": _export(root, "B", 0.25)}


def _server(d, **kw):
    eng = InferenceEngine(d, place=CPU, buckets=kw.pop("buckets", "1,2,4"))
    s = ModelServer(engine=eng, model_dir=d, max_delay_ms=1.0, **kw)
    s.start()
    return s


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_publish_resolve_immutability_and_errors(tmp_path, models):
    d = models["A"][0]
    reg = ModelRegistry(str(tmp_path / "reg"))
    assert reg.versions("mlp") == []
    with pytest.raises(ValueError, match="no published versions"):
        reg.resolve("mlp")
    v1, v2 = reg.publish("mlp", d), reg.publish("mlp", d)
    assert (v1, v2) == (1, 2) and reg.versions("mlp") == [1, 2]
    path, v = reg.resolve("mlp", "latest")
    assert v == 2 and path.endswith(os.path.join("mlp", "2"))
    assert reg.previous("mlp", 2) == 1 and reg.previous("mlp", 1) is None
    assert reg.model_kind("mlp") == "feedforward"
    m = reg.verify("mlp", 2)
    assert m["content_hash"] and m["files"] and m["published_at"] > 0
    assert m["kernel_tier"] == ("cuda" if torch.cuda.is_available()
                                else "torch")
    with pytest.raises(ValueError, match="immutable"):
        reg.publish("mlp", d, version=1)
    with pytest.raises(ValueError, match="no published version 9"):
        reg.resolve("mlp", 9)
    with pytest.raises(ValueError, match="not a save_inference_model"):
        reg.publish("mlp", str(tmp_path))
    with pytest.raises(ValueError, match="one plain path component"):
        reg.resolve("a/b")
    with pytest.raises(ValueError, match="'cuda' or 'torch'"):
        reg.publish("mlp", d, kernel_tier="pallas")
    with pytest.raises(ValueError, match="lineage must be a dict"):
        reg.publish("mlp", d, lineage=["not", "a", "dict"])
    assert reg.versions("mlp") == [1, 2]      # nothing written by either
    # a torn (manifest-less) dir is invisible and never reused
    os.makedirs(os.path.join(reg.model_dir("mlp"), "3"))
    assert reg.versions("mlp") == [1, 2]
    assert reg.publish("mlp", d) == 4


def test_registry_verify_gc_and_cross_package_content_hash(tmp_path,
                                                           models):
    d = models["A"][0]
    reg = ModelRegistry(str(tmp_path / "reg"))
    vs = [reg.publish("mlp", d) for _ in range(5)]
    path, _ = reg.resolve("mlp", vs[0])
    npy = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    with open(os.path.join(path, npy), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\xff")
    with pytest.raises(ValueError, match="corrupt"):
        reg.verify("mlp", vs[0])
    with pytest.raises(ValueError, match="keep_latest"):
        reg.gc("mlp", keep_latest=0)
    # keep the newest 1, its rollback target, and a pinned version
    assert reg.gc("mlp", keep_latest=1, pinned=[2]) == [1, 3]
    assert reg.versions("mlp") == [2, 4, 5]
    # the reference registry hashes the same bundle files the same way
    jreg = JModelRegistry(str(tmp_path / "jreg"))
    jv = jreg.publish("mlp", d, kernel_tier="jnp")
    assert jreg.manifest("mlp", jv)["content_hash"] \
        == reg.manifest("mlp", 5)["content_hash"]
    # and the port's save_inference_model writes the reference's bytes for
    # one program and parameters (the reference's, loaded into the port),
    # so the hashes agree across packages
    from paddle_tpu_torch.serving.execcache import bundle_content_hash
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    main, feeds, fetches = fluid.io.load_inference_model(d, exe,
                                                         scope=scope)
    td = str(tmp_path / "port_saved")
    fluid.io.save_inference_model(td, feeds, fetches, exe, main,
                                  scope=scope)
    assert sorted(os.listdir(td)) == sorted(os.listdir(d))
    assert bundle_content_hash(td) == bundle_content_hash(d) \
        == jreg.manifest("mlp", jv)["content_hash"]


# ---------------------------------------------------------------------------
# the router over in-process servers
# ---------------------------------------------------------------------------

def test_router_balances_and_fails_over_with_probation(models):
    d, xs, want = models["A"]
    s1, s2 = _server(d), _server(d)
    addr1 = s1.address
    s1b = None
    try:
        with FleetClient([addr1, s2.address], probe_interval_ms=30,
                         probation_probes=2) as fc:
            for i in range(16):
                out = fc.infer({"x": xs[i % 8:i % 8 + 1]})
                np.testing.assert_allclose(out[0], want[i % 8:i % 8 + 1],
                                           **TOL)
            fs = fc.fleet_stats()
            served = [r["server"]["wire"]["calls"].get("infer", {}).get(
                "count", 0) for r in fs["replicas"]]
            assert fs["requests"] == 16 and sum(served) == 16
            assert all(n > 0 for n in served), served
            s1.kill()
            for i in range(8):
                out = fc.infer({"x": xs[i:i + 1]})
                np.testing.assert_allclose(out[0], want[i:i + 1], **TOL)
            fs = fc.fleet_stats(include_server_stats=False)
            assert fs["failovers"] >= 1 and fs["ejections"] >= 1
            assert fs["healthy"] == 1
            s1b = _server(d, address=addr1)
            deadline = time.monotonic() + 10.0
            while fc.fleet_stats(include_server_stats=False)["healthy"] < 2 \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert fc.fleet_stats(include_server_stats=False)["healthy"] == 2
    finally:
        s2.shutdown()
        if s1b is not None:
            s1b.shutdown()


def test_router_spills_overload_then_surfaces_it_typed(models):
    d, xs, want = models["A"]
    gates = []

    def slow_server():
        eng = InferenceEngine(d, place=CPU, buckets="1,2")
        gate = threading.Event()
        inner = eng.infer
        eng.infer = lambda feed, fetch_list=None: (
            gate.wait(5.0), inner(feed, fetch_list))[1]
        s = ModelServer(engine=eng, queue_capacity=1, max_delay_ms=1.0)
        s.start()
        gates.append(gate)
        return s

    def hammer(fc, n):
        out = []

        def one(i):
            try:
                np.testing.assert_allclose(
                    fc.infer({"x": xs[i % 8:i % 8 + 1]})[0],
                    want[i % 8:i % 8 + 1], **TOL)
                out.append("ok")
            except ServerOverloaded:
                out.append("overloaded")
        ts = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        return out, ts

    slow, fast = slow_server(), _server(d, buckets="1,2,4")
    try:
        with FleetClient([slow.address, fast.address]) as fc:
            out, ts = hammer(fc, 10)
            deadline = time.monotonic() + 5.0
            while len(out) < 8 and time.monotonic() < deadline:
                time.sleep(0.01)
            gates[0].set()
            for t in ts:
                t.join()
            assert out.count("ok") >= 8, out
    finally:
        slow.shutdown()
        fast.shutdown()
    s1, s2 = slow_server(), slow_server()
    try:
        with FleetClient([s1.address, s2.address]) as fc:
            out, ts = hammer(fc, 8)
            deadline = time.monotonic() + 5.0
            while "overloaded" not in out and time.monotonic() < deadline:
                time.sleep(0.01)
            for g in gates:
                g.set()
            for t in ts:
                t.join()
            assert "overloaded" in out, out
            assert fc.fleet_stats(
                include_server_stats=False)["spillovers"] >= 1
    finally:
        s1.shutdown()
        s2.shutdown()


def test_server_hot_reload_swaps_versions(models):
    (dA, xs, wantA), (dB, _, wantB) = models["A"], models["B"]
    s = _server(dA, version=1)
    try:
        with InferClient(s.address) as c:
            np.testing.assert_allclose(c.infer({"x": xs[:2]})[0],
                                       wantA[:2], **TOL)
            assert s.reload(dB, version=2)["version"] == 2
            np.testing.assert_allclose(c.infer({"x": xs[:2]})[0],
                                       wantB[:2], **TOL)
            assert c.health()["version"] == 2
    finally:
        s.shutdown()


# ---------------------------------------------------------------------------
# the autoscaler's decisions on scripted snapshots
# ---------------------------------------------------------------------------

class _ScriptedFleet:
    """A supervisor stand-in: fleet_metrics() returns the scripted queue
    depth; spawn/retire move a replica count."""

    def __init__(self, depths, n=1):
        self.depths = list(depths)
        self.addresses = [("127.0.0.1", 1000 + i) for i in range(n)]
        self.version = 1
        self.spawned = self.retired = 0
        self.ready = True

    def fleet_metrics(self, include_local=True):
        depth = self.depths.pop(0)
        snap = {"paddle_tpu_server_queue_depth": {
            "type": "gauge", "help": "", "labels": ["instance"],
            "values": [{"labels": {"instance": "s"}, "value": depth}]}}
        return {"merged": snap, "queue_depth": {"total": depth}}

    def spawn_replica(self, wait_timeout=None):
        self.addresses.append(("127.0.0.1", 2000 + len(self.addresses)))
        self.spawned += 1
        return len(self.addresses) - 1, self.addresses[-1]

    def _await_replica(self, i, deadline, target_version=None):
        if not self.ready:
            raise RuntimeError("never ready")

    def retire_replica(self, timeout=10.0):
        self.retired += 1
        return self.addresses.pop()


def _polls(sc, n):
    for _ in range(n):
        sc.poll_once()
        time.sleep(0.01)         # past the rule's window: one poll each


def test_autoscaler_scales_out_in_and_retires_a_failed_canary():
    from paddle_tpu_torch.obs.slo import SloRule
    rule = SloRule("depth", "paddle_tpu_server_queue_depth", objective=8.0,
                   reducer="value", agg="sum", windows=((0.005, 1.0),))
    fleet = _ScriptedFleet([20, 20, 20, 0, 0, 0, 0, 0, 0], n=1)
    sc = FleetAutoscaler(fleet, rules=[rule], min_replicas=1,
                         max_replicas=3, poll_s=0.5, idle_polls=2,
                         registry_warm=False)
    _polls(sc, 3)
    assert fleet.spawned == 2 and sc.replicas() == 3   # capped at max
    assert sc.stats()["breach_active"]
    _polls(sc, 6)
    assert fleet.retired == 2 and sc.replicas() == 1   # floor at min
    st = sc.stats()
    assert (st["scale_ups"], st["scale_downs"]) == (2, 2)
    assert not st["breach_active"]
    bad = _ScriptedFleet([50], n=1)
    bad.ready = False
    sc2 = FleetAutoscaler(bad, rules=[rule], min_replicas=1,
                          max_replicas=2, poll_s=0.5, registry_warm=False,
                          canary_timeout_s=0.1)
    sc2.poll_once()
    assert bad.retired == 1 and sc2.replicas() == 1
    assert sc2.stats()["canary_failures"] == 1
    with pytest.raises(ValueError):
        FleetAutoscaler(fleet, min_replicas=3, max_replicas=2)


# ---------------------------------------------------------------------------
# one spawned fleet of 2 CPU replicas
# ---------------------------------------------------------------------------

def test_spawned_fleet_rollout_canary_and_rejoin(tmp_path, models):
    (dA, xs, wantA), (dB, _, wantB) = models["A"], models["B"]
    reg = ModelRegistry(str(tmp_path / "reg"))
    v1 = reg.publish("mlp", dA, warm_cache=True, place=CPU,
                     warm_kwargs={"buckets": "1,2,4"})
    v2 = reg.publish("mlp", dB)
    bad = tmp_path / "bad"
    shutil.copytree(dA, bad)
    (bad / "__model__").write_text("not a model")
    v3 = reg.publish("mlp", str(bad))
    # the reference's ModelServer on the same bundle (JAX on the CPU)
    jserver = JModelServer(dA, buckets="1,2,4", max_delay_ms=1.0)
    jserver.start()
    try:
        with JInferClient(jserver.address) as jc:
            jwant = jc.infer({"x": xs[:3]})[0]
    finally:
        jserver.shutdown()
    with FleetSupervisor(reg, "mlp", version=v1, n_replicas=2,
                         buckets="1,2,4", max_delay_ms=1.0, place=CPU,
                         startup_grace_s=120.0) as sup:
        assert sup.wait_ready(120.0)
        with FleetClient(sup.addresses, probe_interval_ms=50) as fc:
            got = fc.infer({"x": xs[:3]})[0]
            np.testing.assert_allclose(got, jwant, **TOL)
            np.testing.assert_allclose(got, wantA[:3], **TOL)
            stats = sup.replica_stats()
            for st in stats.values():
                assert st["engine"]["warm_loaded"] == 3      # warm start
                assert st["engine"]["kernel_tier"] == "torch"
            errs, stop = [], threading.Event()

            def hammer():
                while not stop.is_set():
                    try:
                        out = fc.infer({"x": xs[:1]})[0]
                        if not (np.allclose(out, wantA[:1], **TOL)
                                or np.allclose(out, wantB[:1], **TOL)):
                            errs.append("wrong answer")
                    except Exception as e:
                        errs.append(e)
            t = threading.Thread(target=hammer)
            t.start()
            try:
                assert sup.rolling_reload(v2, wait_timeout=120.0) == v2
            finally:
                stop.set()
                t.join()
            assert not errs, errs[:3]
            np.testing.assert_allclose(fc.infer({"x": xs[:3]})[0],
                                       wantB[:3], **TOL)
            with pytest.raises(CanaryFailed) as exc:
                sup.rolling_reload(v3, wait_timeout=120.0)
            assert exc.value.version == v3 and \
                exc.value.rolled_back_to == v2
            assert sup.version == v2
            assert all(sup.replica_health(i)["version"] == v2
                       for i in range(2))
            sup.kill(1)
            np.testing.assert_allclose(fc.infer({"x": xs[:2]})[0],
                                       wantB[:2], **TOL)
            deadline = time.monotonic() + 60.0
            while sup.ready_count() < 2 and time.monotonic() < deadline:
                time.sleep(0.1)
            assert sup.ready_count() == 2 and sup.restarts == [0, 1]
            assert sup.replica_health(1)["version"] == v2   # the registry's
            fm = sup.fleet_metrics()
            assert fm["queue_depth"]["total"] == 0
            assert fm["device_kind"] in ("cpu", torch.cuda.get_device_name(0)
                                         if torch.cuda.is_available()
                                         else "cpu")
