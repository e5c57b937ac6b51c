"""The port's online-learning loop (paddle_tpu_torch/online/) on the CPU:
the counterparts of tests/test_online_learning.py's unit cases and of
tests/test_exec_cache.py::test_rollout_controller_warms_with_fleet_buckets,
and the loop held against the reference.

Consistent pserver cuts (the snapshot API, torn-cut rejection, same-seq
re-push, freezes bitwise the pserver checkpoint for dense and sparse
rowwise params), registry retention gc and numeric latest ordering, the
rollout controller's hysteresis, quarantine, reconvergence and gc, the
trainer's publish cadence, supervisor child stats and the elastic pool's
autoscaler. Cross-package: the StreamingTrainer's losses through a
one-shard sync pserver against the reference's StreamingTrainer on the
same parameters and feeds, and a version the port froze served by the
reference's ``load_inference_model``. The whole loop under chaos is in
``test_torch_online_loop.py``.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.distributed.param_server import serve as jserve
from paddle_tpu.online import StreamingTrainer as JStreamingTrainer
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.distributed import ParamClient
from paddle_tpu_torch.distributed.param_server import install_params, serve
from paddle_tpu_torch.distributed.rpc import RemoteError, RpcClient
from paddle_tpu_torch.online import (CheckpointFreezer, OnlineLearningLoop,
                                     RolloutController, StreamingTrainer)
from paddle_tpu_torch.serving import CanaryFailed, ModelRegistry

CPU = fluid.CPUPlace()


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


# ---------------------------------------------------------------------------
# pserver consistent-cut snapshot API
# ---------------------------------------------------------------------------

def test_snapshot_prepare_fetch_release_and_eviction():
    ps, rpc = serve(optimizer="sgd", opt_kwargs={"lr": 0.5}, mode="sync",
                    fan_in=1)
    rpc.serve_in_thread()
    c = ParamClient([rpc.address])
    try:
        w0 = np.arange(8, dtype=np.float32)
        c.init_params({"w": w0})
        assert c.snapshot_prepare("cut1") == {0: 0}
        for _ in range(3):
            c.push({"w": np.ones(8, np.float32)})
        params, fetch_rounds = c.snapshot_fetch("cut1")
        assert fetch_rounds == {0: 0}
        np.testing.assert_array_equal(params["w"], w0)
        assert params["w"].dtype == np.float32
        assert not np.array_equal(c.pull()["w"], w0)
        c.snapshot_release("cut1", wait=True)
        with pytest.raises(RemoteError, match="unknown snapshot tag"):
            c.snapshot_fetch("cut1")
        r2 = c.snapshot_prepare("cut2")
        c.push({"w": np.ones(8, np.float32)})
        assert c.snapshot_prepare("cut2") == r2
        c.snapshot_release("cut2")
        c.snapshot_release("cut2")
        for i in range(ps._snapshot_cap + 1):
            c.snapshot_prepare(f"e{i}")
        with pytest.raises(RemoteError, match="unknown snapshot tag"):
            c.snapshot_fetch("e0")
        c.snapshot_fetch(f"e{ps._snapshot_cap}")
    finally:
        c.close()
        rpc.shutdown()


def _linear(fl, size=4, lr=0.1, names=True):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", shape=[size])
        y = fl.layers.data("y", shape=[1])
        kw = dict(param_attr=fl.ParamAttr(name="w"),
                  bias_attr=fl.ParamAttr(name="b")) if names else {}
        pred = fl.layers.fc(x, size=1, act=None, **kw)
        loss = fl.layers.mean(fl.layers.square(
            fl.layers.elementwise_sub(pred, y)))
        fl.optimizer.SGD(learning_rate=lr).minimize(loss, startup)
    return main, startup, pred, loss


def _host(scope, names):
    return {n: scope.find_var(n).detach().cpu().numpy() for n in names}


def test_freezer_rejects_torn_cut_and_cuts_consistently(tmp_path):
    _psa, rpc_a = serve(optimizer="sgd", opt_kwargs={"lr": 0.1},
                        mode="sync", fan_in=1)
    _psb, rpc_b = serve(optimizer="sgd", opt_kwargs={"lr": 0.1},
                        mode="sync", fan_in=1)
    rpc_a.serve_in_thread()
    rpc_b.serve_in_thread()
    main, startup, pred, _loss = _linear(fluid)
    t = fluid.DistributeTranspiler()
    t.transpile(0, program=main, pservers="127.0.0.1:1,127.0.0.1:2",
                trainers=1, startup_program=startup)
    client = t.trainer_client(endpoints=[rpc_a.address, rpc_b.address])
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    client.init_params(_host(scope, [p for p, _ in t.params_grads]))
    reg = ModelRegistry(str(tmp_path / "reg"))
    frz = CheckpointFreezer(client, reg, "m", main, ["x"], [pred],
                            executor=exe, template_scope=scope)
    try:
        client.push({"w": np.ones((4, 1), np.float32),
                     "b": np.ones((1,), np.float32)})
        v = frz.request_freeze(1, wait=True, timeout=60)
        m = reg.manifest("m", v)
        assert m["lineage"]["freeze_round"] == 1
        assert m["lineage"]["global_step"] == 1
        assert m["lineage"]["parent_version"] is None
        assert m["published_at"] > 0
        direct = RpcClient(rpc_a.address)
        direct.call("push", grads={"b": np.ones((1,), np.float32)})
        direct.close()
        assert frz.request_freeze(2) is None
        st = frz.stats()
        assert st["failures"].get("torn") == 1
        assert "rounds disagree" in st["last_error"]
        assert reg.versions("m") == [v]
        with pytest.raises(Exception, match="rounds disagree"):
            frz.request_freeze(3, wait=True, timeout=10)
    finally:
        frz.close()
        client.close()
        rpc_a.shutdown()
        rpc_b.shutdown()


def test_same_seq_repush_resyncs_partially_applied_step():
    _psa, rpc_a = serve(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="sync", fan_in=1)
    _psb, rpc_b = serve(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="sync", fan_in=1)
    rpc_a.serve_in_thread()
    rpc_b.serve_in_thread()
    c = ParamClient([rpc_a.address, rpc_b.address])
    try:
        c.init_params({"a": np.zeros(4, np.float32),
                       "b": np.zeros(4, np.float32)})
        g = {"a": np.ones(4, np.float32), "b": np.ones(4, np.float32)}
        c.push(g)
        seq = c.allocate_seq()
        direct = RpcClient(rpc_a.address)
        direct.call("push", grads={"a": np.ones(4, np.float32)},
                    trainer_id=0, seq=seq)
        direct.close()
        assert c.snapshot_prepare("desync") == {0: 2, 1: 1}
        c.snapshot_release("desync")
        c.push(g, seq=seq)
        assert c.snapshot_prepare("resync") == {0: 2, 1: 2}
        params, _ = c.snapshot_fetch("resync")
        c.snapshot_release("resync")
        np.testing.assert_array_equal(params["a"],
                                      np.full(4, -2.0, np.float32))
        np.testing.assert_array_equal(params["b"],
                                      np.full(4, -2.0, np.float32))
    finally:
        c.close()
        rpc_a.shutdown()
        rpc_b.shutdown()


# ---------------------------------------------------------------------------
# bitwise freeze reproducibility (dense + sparse rowwise-optimizer params)
# ---------------------------------------------------------------------------

def test_freeze_bitwise_matches_pserver_checkpoint_dense_and_sparse(
        tmp_path):
    import pickle

    root = str(tmp_path)
    ckpt = os.path.join(root, "shard0.ckpt")
    ps, rpc = serve(optimizer="adam", opt_kwargs={"lr": 0.05}, mode="sync",
                    fan_in=1, checkpoint_path=ckpt, checkpoint_every=1)
    rpc.serve_in_thread()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        y = fluid.layers.data("y", shape=[1])
        emb = fluid.layers.embedding(ids, size=[32, 6], is_sparse=True)
        h = fluid.layers.reshape(emb, [-1, 6])
        pred = fluid.layers.fc(h, size=1, act=None)
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(pred, y)))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss, startup)
    t = fluid.DistributeTranspiler()
    t.transpile(0, program=main, pservers="127.0.0.1:1", trainers=1,
                startup_program=startup)
    assert t.sparse_param_names
    table = t.sparse_param_names[0]
    client = t.trainer_client(endpoints=[rpc.address])
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = [p for p, _ in t.params_grads]
    client.init_params(_host(scope, names))
    reg = ModelRegistry(os.path.join(root, "reg"))
    frz = CheckpointFreezer(client, reg, "m", main, ["ids"], [pred],
                            executor=exe, template_scope=scope)
    trainer_prog = t.get_trainer_program()
    fetch = [g for _p, g in t.params_grads]
    rng = np.random.RandomState(3)

    def step():
        install_params(scope, client.pull(), device=exe.device)
        feed = {"ids": rng.randint(0, 32, (8, 1)).astype(np.int64),
                "y": rng.normal(0, 1, (8, 1)).astype(np.float32)}
        fetched = exe.run(trainer_prog, feed=feed, fetch_list=fetch,
                          scope=scope)
        client.push({p: f if hasattr(f, "rows") else np.asarray(f)
                     for (p, _g), f in zip(t.params_grads, fetched)})

    try:
        for _ in range(5):
            step()
        assert np.ndim(ps._opt_state[table]["t"]) == 1
        v = frz.request_freeze(5, wait=True, timeout=60)
        saved = os.path.join(root, "saved.ckpt")
        shutil.copyfile(ckpt, saved)
        for _ in range(5):
            step()
        with open(saved, "rb") as f:
            want = pickle.load(f)["params"]
        assert want[table].dtype == np.float32
        bundle_dir, _ = reg.resolve("m", v)
        for p in names:
            got = np.load(os.path.join(bundle_dir, p + ".npy"))
            assert got.dtype == want[p].dtype, p
            assert np.array_equal(got, want[p]), p
        assert not np.array_equal(client.pull()[table], want[table])
        scope2 = fluid.Scope()
        prog2, _feeds2, fetches2 = fluid.io.load_inference_model(
            bundle_dir, exe, scope=scope2)
        out = exe.run(prog2, feed={"ids": np.zeros((2, 1), np.int64)},
                      fetch_list=fetches2, scope=scope2)[0]
        assert np.asarray(out).shape == (2, 1)
    finally:
        frz.close()
        client.close()
        rpc.shutdown()


# ---------------------------------------------------------------------------
# cross-package: the streaming trainer and the frozen bundle
# ---------------------------------------------------------------------------

def _stream_losses(trainer_cls, fl, serve_fn, feeds, params, scope_set,
                   exe):
    """Five steps of ``trainer_cls`` through a one-shard sync pserver of
    ``serve_fn`` from ``params``: each step's loss (read by the reader as
    it hands over the next feed; prefetch 0 runs it on the trainer's
    thread after the step that came before)."""
    main, startup, _pred, loss = _linear(fl)
    _ps, rpc = serve_fn(optimizer="sgd", opt_kwargs={"lr": 0.1},
                        mode="sync", fan_in=1)
    rpc.serve_in_thread()
    t = fl.DistributeTranspiler()
    t.transpile(0, program=main, pservers="127.0.0.1:1", trainers=1,
                startup_program=startup)
    client = t.trainer_client(endpoints=[rpc.address])
    scope = fl.Scope()
    exe.run(startup, scope=scope)
    scope_set(scope, params)
    client.init_params(params)
    losses = []
    box = {}

    def reader():
        for f in feeds:
            if box["t"].stats()["last_extra"]:
                losses.append(box["t"].stats()["last_extra"][loss.name])
            yield f

    tr = trainer_cls(exe, scope, t.get_trainer_program(), t.params_grads,
                     client, reader, publish_every_steps=0,
                     publish_every_s=0.0, extra_fetch=[loss], prefetch=0)
    box["t"] = tr
    try:
        tr.start()
        _wait(lambda: not tr.running(), 60, "the trainer's five steps")
        losses.append(tr.stats()["last_extra"][loss.name])
        assert tr.global_step == len(feeds)
        final = client.pull()
    finally:
        tr.stop()
        client.close()
        rpc.shutdown()
    return np.asarray(losses, np.float64).reshape(-1), final


def test_streaming_trainer_losses_match_the_reference():
    rng = np.random.RandomState(11)
    w_true = rng.normal(0, 1, (4, 1)).astype(np.float32)
    feeds = []
    for _ in range(5):
        x = rng.normal(0, 1, (16, 4)).astype(np.float32)
        feeds.append({"x": x, "y": x @ w_true})
    params = {"w": rng.normal(0, 0.5, (4, 1)).astype(np.float32),
              "b": np.zeros((1,), np.float32)}
    port, port_p = _stream_losses(
        StreamingTrainer, fluid, serve, feeds, params,
        lambda s, p: install_params(s, p), fluid.Executor(CPU))
    ref, ref_p = _stream_losses(
        JStreamingTrainer, jfluid, jserve, feeds, params,
        lambda s, p: [s.set(n, v) for n, v in p.items()], jfluid.Executor())
    assert len(port) == len(ref) == 5
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    assert port[-1] < port[0]
    for n in params:
        np.testing.assert_allclose(port_p[n], ref_p[n], rtol=1e-6,
                                   atol=1e-7)


def test_port_frozen_bundle_serves_in_the_reference(tmp_path):
    _ps, rpc = serve(optimizer="sgd", opt_kwargs={"lr": 0.1}, mode="sync",
                     fan_in=1)
    rpc.serve_in_thread()
    main, startup, pred, _loss = _linear(fluid, size=6)
    t = fluid.DistributeTranspiler()
    t.transpile(0, program=main, pservers="127.0.0.1:1", trainers=1,
                startup_program=startup)
    client = t.trainer_client(endpoints=[rpc.address])
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    client.init_params(_host(scope, [p for p, _ in t.params_grads]))
    client.push({"w": np.full((6, 1), 0.5, np.float32),
                 "b": np.ones((1,), np.float32)})
    reg = ModelRegistry(str(tmp_path / "reg"))
    frz = CheckpointFreezer(client, reg, "lin", main, ["x"], [pred],
                            executor=exe, template_scope=scope)
    try:
        v = frz.request_freeze(1, wait=True, timeout=60)
    finally:
        frz.close()
        client.close()
        rpc.shutdown()
    path, _ = reg.resolve("lin", v)
    x = np.random.RandomState(2).normal(0, 1, (5, 6)).astype(np.float32)
    pscope = fluid.Scope()
    prog, feeds, fetches = fluid.io.load_inference_model(path, exe,
                                                         scope=pscope)
    got = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches,
                  scope=pscope)[0]
    jexe = jfluid.Executor()
    jscope = jfluid.Scope()
    jprog, jfeeds, jfetches = jfluid.io.load_inference_model(
        path, jexe, scope=jscope)
    want = jexe.run(jprog, feed={jfeeds[0]: x}, fetch_list=jfetches,
                    scope=jscope)[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# registry retention gc + numeric latest ordering
# ---------------------------------------------------------------------------

def _fake_bundle(root, name="bundle", content=b"model-bytes"):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "__model__"), "wb") as f:
        f.write(content)
    return d


def test_registry_gc_never_deletes_protected_versions(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    src = _fake_bundle(str(tmp_path))
    for _ in range(6):
        reg.publish("m", src)
    assert reg.gc("m", keep_latest=2, pinned={2}) == [1, 3, 4]
    assert reg.versions("m") == [2, 5, 6]
    assert reg.gc("m", keep_latest=1) == [2]
    assert reg.versions("m") == [5, 6]
    assert reg.previous("m", 6) == 5
    assert reg.gc("m", keep_latest=1) == []
    assert reg.gc("m", keep_latest=1, pinned={3}) == []
    assert reg.gc("ghost", keep_latest=1) == []


def test_registry_gc_typed_errors(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    with pytest.raises(ValueError, match="keep_latest must be >= 1"):
        reg.gc("m", keep_latest=0)
    with pytest.raises(ValueError, match="keep_latest must be a positive"):
        reg.gc("m", keep_latest="lots")
    with pytest.raises(ValueError, match="pinned must be an iterable"):
        reg.gc("m", keep_latest=2, pinned=["not-a-version"])
    with pytest.raises(ValueError, match="one plain path component"):
        reg.gc("../escape", keep_latest=2)


def test_registry_latest_is_numeric_and_torn_dirs_are_skipped(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    src = _fake_bundle(str(tmp_path))
    reg.publish("m", src, version=9)
    reg.publish("m", src, version=10)
    assert reg.versions("m") == [9, 10]
    assert reg.resolve("m", "latest")[1] == 10
    assert reg.previous("m", 10) == 9
    torn = os.path.join(reg.model_dir("m"), "11")
    os.makedirs(torn)
    with open(os.path.join(torn, "__model__"), "wb") as f:
        f.write(b"half")
    assert reg.resolve("m", "latest")[1] == 10
    assert reg.publish("m", src) == 12
    assert reg.resolve("m", "latest")[1] == 12
    with pytest.raises(ValueError, match="lineage must be a dict"):
        reg.publish("m", src, lineage=["not", "a", "dict"])


def test_registry_gc_sweeps_abandoned_torn_dirs_only(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    src = _fake_bundle(str(tmp_path))
    for _ in range(3):
        reg.publish("m", src)
    old = os.path.join(reg.model_dir("m"), "90")
    os.makedirs(old)
    with open(os.path.join(old, "__model__"), "wb") as f:
        f.write(b"half")
    past = time.time() - 7200
    os.utime(old, (past, past))
    fresh = os.path.join(reg.model_dir("m"), "91")
    os.makedirs(fresh)
    assert reg.gc("m", keep_latest=2) == [1, 90]
    assert not os.path.exists(old) and os.path.isdir(fresh)
    assert reg.versions("m") == [2, 3]
    assert reg.gc("m", keep_latest=2, torn_ttl_s=0) == [91]
    assert not os.path.exists(fresh)
    with pytest.raises(ValueError, match="torn_ttl_s must be >= 0"):
        reg.gc("m", torn_ttl_s=-1)
    with pytest.raises(ValueError, match="torn_ttl_s must be a non-neg"):
        reg.gc("m", torn_ttl_s="soon")


def test_rolling_reload_classifies_canary_reject_vs_unreachable():
    from paddle_tpu_torch.serving.fleet import FleetSupervisor

    sup = FleetSupervisor.__new__(FleetSupervisor)
    sup._version_lock = threading.Lock()
    sup._version = 1
    sup.addresses = [("127.0.0.1", 1), ("127.0.0.1", 2)]
    sup.model = "m"

    class _Reg:
        def resolve(self, model, version):
            return "/fake/path", int(version)

    sup.registry = _Reg()
    sup._await_replica = lambda i, deadline, target_version=None: None
    rollbacks = []
    sup._rollback_canary = lambda prev, t: rollbacks.append(prev)
    sup._reload_replica = lambda i, path, version, timeout: RemoteError(
        "reload", "ValueError", "corrupt bundle")
    with pytest.raises(CanaryFailed) as ei:
        sup.rolling_reload(2)
    assert ei.value.version == 2 and ei.value.rolled_back_to == 1
    assert rollbacks == [1]
    sup._reload_replica = lambda i, path, version, timeout: \
        ConnectionError("canary died mid-reload")
    with pytest.raises(RuntimeError, match="not condemned") as ei:
        sup.rolling_reload(2)
    assert not isinstance(ei.value, CanaryFailed)
    assert rollbacks == [1, 1]
    assert sup.version == 1


def test_trainer_cadence_retries_after_failed_async_stitch():
    from paddle_tpu_torch.online.freezer import FreezeError, _Job

    tr = StreamingTrainer(None, None, None, params_grads=[], client=None,
                          reader=None, freezer=object(),
                          publish_every_steps=100, publish_every_s=0.0)
    now = time.monotonic()
    assert not tr._publish_due(1, now)
    job = _Job("t", 0, 5)
    tr._pending_job = job
    assert not tr._publish_due(1, now)
    job.resolve(version=7)
    assert not tr._publish_due(1, now)
    failed = _Job("t2", 0, 6)
    tr._pending_job = failed
    failed.resolve(error=FreezeError("shard restarted mid-fetch"))
    assert tr._publish_due(1, now)
    assert tr._pending_job is None
    assert not tr._publish_due(1, now)
    assert tr._publish_due(100, now)


# ---------------------------------------------------------------------------
# RolloutController: hysteresis, quarantine, monotonic targets
# ---------------------------------------------------------------------------

class _FakeFleet:
    def __init__(self, version=1, fail_versions=()):
        self.version = version
        self.calls = []
        self.fail_versions = set(fail_versions)

    def rolling_reload(self, version, wait_timeout=None):
        self.calls.append(version)
        if version in self.fail_versions:
            raise CanaryFailed(f"canary rejected {version}",
                               version=version,
                               rolled_back_to=self.version)
        self.version = version
        return version


def test_rollout_controller_hysteresis_skips_to_newest(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    src = _fake_bundle(str(tmp_path))
    for _ in range(4):
        reg.publish("m", src)
    sup = _FakeFleet(version=1)
    ctl = RolloutController(reg, "m", sup, poll_interval_s=0.05,
                            min_serve_s=0.4, rollout_timeout_s=5.0)
    ctl.start()
    try:
        _wait(lambda: sup.version == 4, 20.0, "the rollout to v4")
        assert sup.calls == [4]
        st = ctl.stats()
        assert st["rollouts"] == 1 and st["served_version"] == 4
        assert st["publish_to_served"]["count"] == 1
    finally:
        ctl.stop()


def test_rollout_controller_quarantines_canary_failures(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    src = _fake_bundle(str(tmp_path))
    reg.publish("m", src)
    reg.publish("m", src)
    sup = _FakeFleet(version=1, fail_versions={2})
    ctl = RolloutController(reg, "m", sup, poll_interval_s=0.05,
                            min_serve_s=0.0, rollout_timeout_s=5.0)
    ctl.start()
    try:
        _wait(lambda: ctl.stats()["rollbacks"], 20.0, "the rollback")
        st = ctl.stats()
        assert st["rollbacks"] == 1 and st["bad_versions"] == [2]
        assert sup.version == 1
        time.sleep(0.3)
        assert sup.calls.count(2) == 1
        v3 = reg.publish("m", src)
        _wait(lambda: sup.version == v3, 20.0, "the rollout to v3")
        assert ctl.stats()["bad_versions"] == [2]
        assert 2 not in sup.calls[sup.calls.index(v3):]
    finally:
        ctl.stop()


def test_rollout_controller_reconverges_mixed_fleet(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    src = _fake_bundle(str(tmp_path))
    reg.publish("m", src)
    reg.publish("m", src)

    class _MixedFleet(_FakeFleet):
        def __init__(self):
            super().__init__(version=1)
            self.addresses = [("127.0.0.1", 1), ("127.0.0.1", 2)]
            self.replica_versions = [1, 1]
            self.failed_once = False

        def replica_health(self, i):
            return {"status": "serving", "warmed": True,
                    "version": self.replica_versions[i]}

        def rolling_reload(self, version, wait_timeout=None):
            self.calls.append(version)
            self.replica_versions[0] = version
            self.version = version
            if not self.failed_once:
                self.failed_once = True
                raise RuntimeError("rolling_reload: replica 1 failed after "
                                   "the canary passed")
            self.replica_versions[1] = version
            return version

    sup = _MixedFleet()
    ctl = RolloutController(reg, "m", sup, poll_interval_s=0.05,
                            min_serve_s=0.0, rollout_timeout_s=5.0)
    ctl.start()
    try:
        _wait(lambda: sup.replica_versions == [2, 2], 20.0,
              "the reconvergence")
        st = ctl.stats()
        assert st["converge_repairs"] == 1 and st["errors"] >= 1
        assert sup.calls == [2, 2]
        time.sleep(0.3)
        assert sup.calls == [2, 2]
    finally:
        ctl.stop()


def test_rollout_controller_gc_after_rollout_pins_served(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    src = _fake_bundle(str(tmp_path))
    for _ in range(5):
        reg.publish("m", src)
    sup = _FakeFleet(version=1)
    ctl = RolloutController(reg, "m", sup, poll_interval_s=0.05,
                            min_serve_s=0.0, rollout_timeout_s=5.0,
                            registry_keep=2)
    ctl.start()
    try:
        _wait(lambda: sup.version == 5 and ctl.stats()["gc_deleted"] == 3,
              20.0, "the rollout and its gc")
        assert reg.versions("m") == [4, 5]
    finally:
        ctl.stop()


def test_rollout_controller_warms_with_fleet_buckets(tmp_path):
    """``warm_cache=True`` builds the artifacts of the FLEET'S geometry
    (the supervisor's buckets) before it rolls the version out."""
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    main, startup, pred, _loss = _linear(fluid, size=6, names=False)
    exe.run(startup, scope=scope)
    export = str(tmp_path / "export")
    fluid.io.save_inference_model(export, ["x"], [pred], exe, main,
                                  scope=scope)
    reg = ModelRegistry(str(tmp_path / "reg"))
    v = reg.publish("m", export)

    class _StubSup:
        _cfg = {"buckets": "1,4"}
        addresses = []
        version = 0

        def rolling_reload(self, target, wait_timeout=None):
            self.rolled = target

    sup = _StubSup()
    ctl = RolloutController(reg, "m", sup, warm_cache=True,
                            warm_kwargs={"place": CPU}, min_serve_s=0.0,
                            poll_interval_s=60.0)
    assert ctl._warm_kwargs["buckets"] == "1,4"
    ctl._last_rollout_t = 0.0
    ctl._poll()
    assert sup.rolled == v
    warm_files = reg.manifest("m", v)["warm_files"]
    tags = {f.split("/")[1].split("-")[0] for f in warm_files}
    assert tags == {"infer_b1", "infer_b4"}, tags


# ---------------------------------------------------------------------------
# supervisor observability, the loop's surface, the elastic pool
# ---------------------------------------------------------------------------

def test_child_supervisor_exposes_restart_stats():
    from paddle_tpu_torch.distributed.launch import ChildSupervisor
    from paddle_tpu_torch.testing import elastic

    class _Echo(ChildSupervisor):
        def _child_spec(self, i):
            return elastic.echo_child, (self.addresses[i], i)

    # the children are fresh interpreters: misses count after their start
    with _Echo(2, heartbeat_interval_s=0.1, startup_grace_s=30.0) as sup:
        assert sup.wait_ready(30.0)
        before = time.time()
        stats = sup.child_stats()
        assert [s["restart_count"] for s in stats] == [0, 0]
        assert [s["last_restart_at"] for s in stats] == [None, None]
        assert all(s["alive"] and not s["gave_up"] for s in stats)
        assert stats[0]["address"] == tuple(sup.addresses[0])
        sup.kill(0)
        _wait(lambda: sup.child_stats()[0]["restart_count"] == 1, 30.0,
              "the restart")
        s0 = sup.child_stats()[0]
        assert s0["last_restart_at"] is not None \
            and s0["last_restart_at"] >= before
        assert sup.child_stats()[1]["restart_count"] == 0


def test_loop_stop_resets_started_flag(tmp_path):
    loop = OnlineLearningLoop(None, None, None, [], [],
                              registry_root=str(tmp_path / "reg"),
                              place=CPU)
    loop._started = True
    loop.stop()
    assert loop.stats()["started"] is False
    loop.stop()


def test_loop_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """``place=None`` is the card: without one, building the loop raises
    (as ``resolve_device`` does) before anything is spawned."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: place=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineLearningLoop(None, None, None, [], [],
                           registry_root=str(tmp_path / "reg"))
    with pytest.raises(RuntimeError, match="CUDA"):
        CheckpointFreezer(None, None, "m", fluid.Program(), [], [])


class _FakePoolClient:
    def register_trainer(self):
        return 0.5

    def deregister_trainer(self):
        return True

    def close(self):
        pass


class _FakePoolTrainer:
    def __init__(self, wid, stop_ev):
        self.obs_instance = f"fakepool-w{wid}"
        self._client = _FakePoolClient()
        self._stop_ev = stop_ev
        self._running = False
        self.global_step = 0

    def start(self):
        self._running = True

    def running(self):
        return self._running and not self._stop_ev.is_set()

    def stop(self, timeout=30.0):
        self._running = False
        return True

    def stats(self):
        return {"global_step": self.global_step}


def test_trainer_pool_autoscale_closed_loop():
    from paddle_tpu_torch.obs.metrics import REGISTRY
    from paddle_tpu_torch.obs.recorder import IncidentCollector
    from paddle_tpu_torch.online import BacklogAutoscaler, TrainerPool

    pool = TrainerPool(lambda wid, ev: _FakePoolTrainer(wid, ev),
                       min_workers=1, max_workers=3, supervise_s=0.05)
    incidents = IncidentCollector(addresses=[], cooldown_s=0.0)
    pool.incident_hook = incidents.trigger
    pool.start()
    try:
        assert pool.size() == 1
        backlog = {"pending": 40, "leased": 0, "failed": 0}
        scaler = BacklogAutoscaler(pool, lambda: dict(backlog),
                                   poll_s=0.05, idle_polls=2)
        deadline = time.monotonic() + 5.0
        while pool.size() < 3 and time.monotonic() < deadline:
            scaler.poll_once()
            time.sleep(0.05)
        assert pool.size() == 3, scaler.stats()
        fam = REGISTRY.snapshot()["paddle_tpu_online_backlog_tasks"]
        mine = [v for v in fam["values"]
                if v["labels"].get("instance") == pool.obs_instance]
        assert mine and mine[0]["value"] == 40.0
        backlog = {"pending": 0, "leased": 0, "failed": 0}
        deadline = time.monotonic() + 10.0
        while pool.size() > 1 and time.monotonic() < deadline:
            scaler.poll_once()
            time.sleep(0.05)
        assert pool.size() == 1, scaler.stats()
        sst = scaler.stats()
        assert sst["scale_ups"] >= 2 and sst["scale_downs"] >= 2, sst
        [wid] = pool.worker_ids()
        assert pool.kill(wid)
        _wait(lambda: pool.size() == 1, 10.0, "the replacement")
        st = pool.stats()
        assert st["joins"] >= 4 and st["leaves"] >= 2
        assert st["lease_expired"] == 1
        assert incidents.wait_idle(10.0)
        assert incidents.stats()["captures"] >= 1
        bundle = incidents.bundles[-1]
        kinds = {e["kind"] for e in bundle["events"]
                 if e["detail"].get("worker") is not None
                 or e["kind"].startswith("trainer_")}
        assert "trainer_join" in kinds and "trainer_leave" in kinds, kinds
    finally:
        pool.stop()
    assert pool.size() == 0
