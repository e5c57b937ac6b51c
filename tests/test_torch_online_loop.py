"""The port's whole online-learning loop on the CPU under chaos: the
counterparts of tests/test_online_learning.py's two end-to-end cases.

* ``OnlineLearningLoop`` (2 pserver shards, the streaming trainer, the
  freezer, 2 spawned serving replicas, the rollout controller) while a
  pserver shard and a replica are SIGKILLed and corrupt versions are
  published: zero failed infer requests, a served version that never goes
  back over at least two rollouts, the corrupt version canary-rejected
  and quarantined, both children restarted.
* The elastic mode: a Master-fed ``TrainerPool`` of two workers, one
  killed mid-stream and replaced, training stepping on, the served
  version advancing, every pserver round shrunk past the dead worker and
  none broken.

Every wait has its own deadline, well inside the file's minute; the
supervisors restart SIGKILLed children on their fixed addresses, whose
ports the killed processes no longer hold.
"""

import json
import threading
import time

import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.distributed import RetryPolicy
from paddle_tpu_torch.distributed.rpc import RpcClient
from paddle_tpu_torch.online import OnlineLearningLoop
from paddle_tpu_torch.serving import FleetClient

CPU = fluid.CPUPlace()


def _linear(size):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[size])
        y = fluid.layers.data("y", shape=[1])
        pred = fluid.layers.fc(x, size=1, act=None)
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(pred, y)))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss, startup)
    return main, startup, pred


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def test_online_loop_end_to_end_chaos(tmp_path):
    main, startup, pred = _linear(6)
    w_true = np.random.RandomState(0).normal(0, 1, (6, 1)) \
        .astype(np.float32)

    def reader():
        r = np.random.RandomState(1)
        while True:
            X = r.normal(0, 1, (16, 6)).astype(np.float32)
            yield {"x": X, "y": X @ w_true}

    loop = OnlineLearningLoop(
        main, startup, reader, ["x"], [pred],
        registry_root=str(tmp_path / "reg"), model="lin",
        n_pservers=2, n_replicas=2, publish_every_steps=15,
        min_serve_s=0.5, rollout_poll_s=0.2, buckets="1,2",
        max_delay_ms=1.0, checkpoint_dir=str(tmp_path / "ckpt"),
        place=CPU)
    errs, served_seen, infers = [], [], [0]
    stop = threading.Event()

    def hammer():
        fc = FleetClient(loop.fleet.addresses,
                         retry=RetryPolicy(max_retries=10,
                                           backoff_base_s=0.05,
                                           backoff_max_s=0.5))
        X = np.zeros((1, 6), np.float32)
        try:
            while not stop.is_set():
                try:
                    out = fc.infer({"x": X})
                    infers[0] += 1
                    assert np.asarray(out[0]).shape == (1, 1)
                except Exception as e:
                    errs.append(repr(e))
        finally:
            fc.close()

    ht = None
    try:
        assert loop.start(wait_ready_s=60.0) == 1
        ht = threading.Thread(target=hammer, daemon=True)
        ht.start()
        killed, poisoned = False, 0
        deadline = time.monotonic() + 40.0
        while time.monotonic() < deadline:
            st = loop.stats(fleet_metrics=False)
            served_seen.append(st["served_version"])
            rollouts = st["rollout"]["rollouts"]
            if rollouts >= 1 and not killed:
                loop.pservers.kill(1)
                loop.fleet.kill(1)
                killed = True
            if killed and not st["rollout"]["rollbacks"] and poisoned < 40:
                bad = tmp_path / "bad"
                bad.mkdir(exist_ok=True)
                (bad / "__model__").write_text("not a model")
                loop.registry.publish("lin", str(bad))
                poisoned += 1
            if rollouts >= 2 and poisoned \
                    and loop.rollout.stats()["rollbacks"] >= 1:
                break
            time.sleep(0.4)
        stop.set()
        ht.join(15.0)
        assert not ht.is_alive(), "the infer client never returned"
        st = loop.stats()
        assert not errs, f"infer requests failed: {errs[:3]}"
        assert infers[0] > 0
        assert st["rollout"]["rollouts"] >= 2, st["rollout"]
        assert all(b >= a for a, b in zip(served_seen, served_seen[1:])), \
            f"served version regressed: {served_seen}"
        assert st["served_version"] > 1
        ro = st["rollout"]
        assert ro["rollbacks"] >= 1 and ro["bad_versions"], ro
        assert st["served_version"] not in ro["bad_versions"]
        assert sum(c["restart_count"] for c in st["pserver_children"]) >= 1
        assert sum(c["restart_count"] for c in st["fleet_children"]) >= 1
        fm = st["metrics"]
        assert sum(v["value"] for v in
                   fm["paddle_tpu_online_trainer_steps"]["values"]) > 0
        assert "paddle_tpu_engine_compiles" in fm
        json.dumps(st)
        assert st["trainer"]["global_step"] > 30
        versions = st["published_versions"]
        assert len(versions) >= 3
        steps = [loop.registry.manifest("lin", v)["lineage"]["global_step"]
                 for v in versions
                 if "lineage" in loop.registry.manifest("lin", v)]
        assert steps == sorted(steps)
    finally:
        stop.set()
        if ht is not None:
            ht.join(15.0)
        loop.stop()


def test_online_loop_elastic_pool_kill_and_hot_join(tmp_path):
    main, startup, pred = _linear(4)
    w_true = np.random.RandomState(0).normal(0, 1, (4, 1)) \
        .astype(np.float32)

    def chunk_feeds(chunk):
        r = np.random.RandomState(int(chunk) % 1024)
        for _ in range(2):
            X = r.normal(0, 1, (8, 4)).astype(np.float32)
            yield {"x": X, "y": X @ w_true}

    loop = OnlineLearningLoop(
        main, startup, None, ["x"], [pred],
        registry_root=str(tmp_path / "reg"), model="lin",
        n_pservers=2, n_replicas=1, publish_every_s=0.4,
        min_serve_s=0.2, rollout_poll_s=0.1,
        checkpoint_dir=str(tmp_path / "ckpt"),
        chunks=list(range(200000)), chunk_feeds=chunk_feeds,
        trainers_min=2, trainers_max=3, autoscale=False,
        trainer_lease_s=1.0, master_timeout_s=1.5, place=CPU)
    try:
        assert loop.start(wait_ready_s=60.0) == 1
        _wait(lambda: loop.pool.global_step() >= 30, 20.0,
              "30 steps of the pool")
        ids = loop.pool.worker_ids()
        assert loop.pool.kill(ids[0])
        _wait(lambda: loop.pool.size() == 2, 15.0,
              "the hot-join replacement")
        mark = loop.pool.global_step()
        _wait(lambda: loop.pool.global_step() >= mark + 30, 20.0,
              "30 steps after the kill")
        _wait(lambda: loop.fleet.version >= 3, 30.0,
              "two rollouts past v1")
        st = loop.stats(fleet_metrics=False)
        assert st["served_version"] >= 3, st["rollout"]
        assert st["pool"]["joins"] >= 3
        assert st["pool"]["lease_expired"] >= 1
        assert st["backlog"]["pending"] > 0
        assert st["publish_pacer"]["accepted"] >= 2
        for a in loop.pservers.addresses:
            cli = RpcClient(tuple(a))
            s = cli.call("stats")
            cli.close()
            assert s["rounds_broken"] == 0
            assert s["rounds_shrunk"] >= 1
        steps = [loop.registry.manifest("lin", v)["lineage"]["global_step"]
                 for v in st["published_versions"]]
        assert steps == sorted(steps)
    finally:
        loop.stop()
