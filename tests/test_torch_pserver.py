"""The port's parameter server and elastic master, multiprocess on
localhost: the counterparts of tests/test_distributed.py, case by case.

The server, master and clients are the port's (paddle_tpu_torch.
distributed); the fluid trainers are the port's Executor on the CPU, their
pulled parameters installed into the scope's tensors. Worker and victim
processes are fresh interpreters (``launch.spawn_child``) running the
functions of ``paddle_tpu_torch.testing.elastic``: they import numpy and
``distributed/`` only. Every wait is bounded: a state the test needs is
waited for on an event or a deadline poll, and every process is joined
with a timeout.
"""

import os
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.distributed import (ParamClient, serve, shard_names,
                                          Master, MasterClient, RpcServer,
                                          RpcClient, install_params)
from paddle_tpu_torch.distributed.launch import spawn_child
from paddle_tpu_torch.testing import elastic

JOIN_S = 60.0


def _wait_until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _start_ps(**kw):
    ps, rpc = serve(**kw)
    rpc.serve_in_thread()
    return ps, rpc


# ---------------------------------------------------------------------------
# parameter server
# ---------------------------------------------------------------------------

def test_sync_mode_matches_combined_sgd():
    """fan_in=2 sync: the server updates once per round with the averaged
    gradient — identical to single-process SGD on the combined batch."""
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 0.1},
                        mode="sync", fan_in=2)
    c1 = ParamClient([rpc.address], trainer_id=0)
    c2 = ParamClient([rpc.address], trainer_id=1, param_names=["w"])
    w0 = np.ones((4,), np.float32)
    c1.init_params({"w": w0})
    g1 = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    g2 = np.array([3.0, 2.0, 1.0, 0.0], np.float32)
    t = threading.Thread(target=lambda: c2.push({"w": g2}))
    t.start()
    c1.push({"w": g1})
    t.join(JOIN_S)
    got = c1.pull()["w"]
    np.testing.assert_allclose(got, w0 - 0.1 * (g1 + g2) / 2.0, rtol=1e-6)
    rpc.shutdown()


def test_sync_mode_blocks_until_fan_in():
    ps, rpc = _start_ps(mode="sync", fan_in=2)
    c1 = ParamClient([rpc.address])
    c1.init_params({"w": np.zeros((2,), np.float32)})
    done = threading.Event()

    def push_one():
        c1.push({"w": np.ones((2,), np.float32)})
        done.set()

    threading.Thread(target=push_one, daemon=True).start()
    assert not done.wait(0.3)  # the barrier holds with 1 of 2 pushes
    c2 = ParamClient([rpc.address], trainer_id=1, param_names=["w"])
    c2.push({"w": np.ones((2,), np.float32)})
    assert done.wait(5.0)
    rpc.shutdown()


def test_async_mode_applies_immediately_and_converges():
    """Two async trainers fitting y = Xw: each pushes its own grads with no
    barrier; the server-resident optimizer converges."""
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 0.05},
                        mode="async")
    rng = np.random.RandomState(0)
    w_true = rng.normal(0, 1, (8,)).astype(np.float32)
    c0 = ParamClient([rpc.address], trainer_id=0)
    c0.init_params({"w": np.zeros((8,), np.float32)})

    def trainer(tid, steps=150):
        c = ParamClient([rpc.address], trainer_id=tid, param_names=["w"])
        r = np.random.RandomState(tid)
        for _ in range(steps):
            w = c.pull()["w"]
            X = r.normal(0, 1, (16, 8)).astype(np.float32)
            grad = 2.0 * X.T @ (X @ w - X @ w_true) / len(X)
            c.push({"w": grad})
        c.close()

    ts = [threading.Thread(target=trainer, args=(tid,)) for tid in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
    np.testing.assert_allclose(c0.pull()["w"], w_true, atol=0.05)
    steps = ps.stats()["trainer_steps"]
    assert steps.get(1, 0) == 150 and steps.get(2, 0) == 150
    rpc.shutdown()


def test_async_bounded_staleness_blocks_fast_trainer():
    ps, rpc = _start_ps(mode="async", max_staleness=2)
    c = ParamClient([rpc.address], trainer_id=0)
    c.init_params({"w": np.zeros((2,), np.float32)})
    slow = ParamClient([rpc.address], trainer_id=1, param_names=["w"])
    fast = ParamClient([rpc.address], trainer_id=2, param_names=["w"])
    g = {"w": np.ones((2,), np.float32)}
    slow.push(g)  # slow at 1
    for _ in range(3):
        fast.push(g)  # fast reaches 3 = 1 + staleness 2
    released = threading.Event()

    def push_fast():
        fast.push(g)  # would be 4, 3 ahead -> must block
        released.set()

    threading.Thread(target=push_fast, daemon=True).start()
    assert not released.wait(0.3)
    slow.push(g)  # slow catches up to 2 -> fast may proceed
    assert released.wait(5.0)
    rpc.shutdown()


def test_sharding_across_two_servers():
    ps1, rpc1 = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0})
    ps2, rpc2 = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0})
    c = ParamClient([rpc1.address, rpc2.address])
    params = {f"p{i}": np.full((2,), float(i), np.float32)
              for i in range(5)}
    c.init_params(params)
    # round-robin by sorted name: p0,p2,p4 on shard 0; p1,p3 on shard 1
    assert ps1.stats()["params"] == ["p0", "p2", "p4"]
    assert ps2.stats()["params"] == ["p1", "p3"]
    assert shard_names(params, 2) == [["p0", "p2", "p4"], ["p1", "p3"]]
    c.push({n: np.ones((2,), np.float32) for n in params})
    got = c.pull()
    for i in range(5):
        np.testing.assert_allclose(got[f"p{i}"], float(i) - 1.0)
    rpc1.shutdown()
    rpc2.shutdown()


def _regression_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6])
        y = fluid.layers.data("y", shape=[1])
        pred = fluid.layers.fc(x, size=1, act=None,
                               param_attr=fluid.ParamAttr(name="w"),
                               bias_attr=fluid.ParamAttr(name="b"))
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(pred, y)))
        # forward+backward only; the update lives on the pserver
        fluid.append_backward(loss)
    return main, startup, loss


def test_fluid_trainer_through_pserver():
    """A port fluid program trains with the optimizer ON the server: the
    trainer program is forward+backward only, and every pull lands in the
    scope's tensors on the executor's device (the same tensor objects:
    nothing is reallocated)."""
    import torch
    import paddle_tpu_torch.fluid as fluid

    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 0.1},
                        mode="async")
    main, startup, loss = _regression_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    held = {n: scope.find_var(n) for n in ("w", "b")}
    client = ParamClient([rpc.address])
    client.init_params({n: scope.find_var(n).numpy() for n in ("w", "b")})
    rng = np.random.RandomState(1)
    w_true = rng.normal(0, 1, (6, 1)).astype(np.float32)
    losses = []
    for _ in range(60):
        install_params(scope, client.pull(), device=exe.device)  # recv
        for n, t in held.items():
            v = scope.find_var(n)
            assert v is t and isinstance(v, torch.Tensor)
            assert v.device == exe.device
        X = rng.normal(0, 1, (32, 6)).astype(np.float32)
        l, gw, gb = exe.run(main, feed={"x": X, "y": X @ w_true},
                            fetch_list=[loss, "w@GRAD", "b@GRAD"],
                            scope=scope)
        client.push({"w": gw, "b": gb})  # send grads
        losses.append(float(l))
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
    rpc.shutdown()


# ---------------------------------------------------------------------------
# elastic master
# ---------------------------------------------------------------------------

def _start_master(**kw):
    m = Master(**kw)
    rpc = RpcServer(m)
    rpc.serve_in_thread()
    return m, rpc


def test_master_dispatch_and_finish():
    m, rpc = _start_master()
    c = MasterClient(rpc.address)
    assert c.set_dataset([f"chunk{i}" for i in range(6)],
                         chunks_per_task=2) == 3
    seen = []
    for task_id, epoch, chunks in c.tasks():
        seen.extend(chunks)
        c.finished(task_id, epoch)
    assert sorted(seen) == [f"chunk{i}" for i in range(6)]
    assert c.progress() == {"todo": 0, "doing": 0, "done": 3, "pass_id": 1}
    rpc.shutdown()


def test_master_lease_timeout_redispatches():
    """A trainer that leases a task and dies: the lease expires and another
    trainer gets the same chunks."""
    m, rpc = _start_master(timeout_s=0.3)
    c = MasterClient(rpc.address)
    c.set_dataset(["a", "b"], chunks_per_task=1)
    t1 = c.get_task()                      # leased... then the trainer dies
    time.sleep(0.5)                        # the lease's own clock runs out
    seen = []
    for task_id, epoch, chunks in c.tasks():
        seen.extend(chunks)
        c.finished(task_id, epoch)
    assert sorted(seen) == ["a", "b"]     # the dead lease was re-dispatched
    assert c.finished(t1["task_id"], t1["epoch"]) is False   # stale epoch
    rpc.shutdown()


def test_master_retry_limit_drops_poison_task():
    m, rpc = _start_master(failure_max=2)
    c = MasterClient(rpc.address)
    c.set_dataset(["poison", "good"])
    completed, dropped = [], 0
    for task_id, epoch, chunks in c.tasks():
        if chunks == ["poison"]:
            c.failed(task_id, epoch)
            dropped += 1
        else:
            completed.extend(chunks)
            c.finished(task_id, epoch)
    assert completed == ["good"]
    assert dropped == 2  # failure_max attempts, then discarded
    rpc.shutdown()


def test_master_snapshot_recovery(tmp_path):
    """A restarted master resumes the pass from its snapshot with leased
    tasks re-queued."""
    snap = str(tmp_path / "master.snap")
    m, rpc = _start_master(snapshot_path=snap, snapshot_every=1)
    c = MasterClient(rpc.address)
    c.set_dataset(["a", "b", "c"])
    c.get_task()
    t2 = c.get_task()
    c.finished(t2["task_id"], t2["epoch"])
    rpc.shutdown()  # the master "crashes" with one task still leased

    m2, rpc2 = _start_master(snapshot_path=snap)
    c2 = MasterClient(rpc2.address)
    remaining = []
    for task_id, epoch, chunks in c2.tasks():
        remaining.extend(chunks)
        c2.finished(task_id, epoch)
    assert sorted(remaining) == sorted({"a", "b", "c"} - set(t2["chunks"]))
    rpc2.shutdown()


def test_elastic_end_to_end_kill_trainer():
    """Chunks dispatched to 2 workers + 1 victim process killed mid-lease;
    every chunk is still processed (by lease re-dispatch) and training on
    the consumed chunks converges."""
    m, rpc = _start_master(timeout_s=0.5)
    c = MasterClient(rpc.address)
    rng = np.random.RandomState(0)
    w_true = rng.normal(0, 1, (4,)).astype(np.float32)
    chunks = [f"c{i}" for i in range(8)]
    chunk_data = {name: (lambda X: (X, X @ w_true))(
        rng.normal(0, 1, (64, 4)).astype(np.float32)) for name in chunks}
    c.set_dataset(chunks)

    victim = spawn_child(elastic.victim_trainer, (list(rpc.address), 30.0))
    try:
        _wait_until(lambda: c.backlog()["leased"] == 1, 30.0,
                    "the victim's lease")
    finally:
        victim.terminate()
        victim.join(JOIN_S)
    assert not victim.is_alive()

    ps, ps_rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 0.05},
                           mode="async")
    pc0 = ParamClient([ps_rpc.address])
    pc0.init_params({"w": np.zeros((4,), np.float32)})
    processed = []
    plock = threading.Lock()

    def worker(tid):
        mc = MasterClient(rpc.address)
        pc = ParamClient([ps_rpc.address], trainer_id=tid, param_names=["w"])
        for task_id, epoch, names in mc.tasks():
            for name in names:
                X, y = chunk_data[name]
                for _ in range(25):
                    w = pc.pull()["w"]
                    pc.push({"w": 2.0 * X.T @ (X @ w - y) / len(X)})
                with plock:
                    processed.append(name)
            mc.finished(task_id, epoch)
        mc.close()

    ts = [threading.Thread(target=worker, args=(tid,)) for tid in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
    assert sorted(processed) == sorted(chunks)  # incl. the victim's chunk
    np.testing.assert_allclose(pc0.pull()["w"], w_true, atol=0.05)
    rpc.shutdown()
    ps_rpc.shutdown()


def test_overlapped_remote_updater():
    """The CONCURRENT updater contract: push/pull run off the training
    thread, params carry one-step staleness, training still converges, and
    sync_in installs into the scope's tensors."""
    import torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.distributed import OverlappedRemoteUpdater

    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 0.1},
                        mode="async")
    main, startup, loss = _regression_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    client = ParamClient([rpc.address])
    client.init_params({n: scope.find_var(n).numpy() for n in ("w", "b")})

    comm_threads = set()
    orig_push = client.push

    def spy_push(grads):
        comm_threads.add(threading.get_ident())
        return orig_push(grads)

    client.push = spy_push
    upd = OverlappedRemoteUpdater(client, scope, ["w", "b"],
                                  device=exe.device)
    rng = np.random.RandomState(1)
    w_true = rng.normal(0, 1, (6, 1)).astype(np.float32)
    losses = []
    for _ in range(60):
        upd.sync_in()
        X = rng.normal(0, 1, (32, 6)).astype(np.float32)
        l, gw, gb = exe.run(main, feed={"x": X, "y": X @ w_true},
                            fetch_list=[loss, "w@GRAD", "b@GRAD"],
                            scope=scope)
        upd.submit({"w": gw, "b": gb})
        losses.append(float(l))
    upd.finish()
    assert all(isinstance(scope.find_var(n), torch.Tensor)
               and scope.find_var(n).device == exe.device
               for n in ("w", "b"))
    assert comm_threads and threading.get_ident() not in comm_threads
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])
    client.close()
    rpc.shutdown()


def test_install_params_copies_in_place_and_refuses_a_mismatch():
    """A held name is copied into its tensor (same object), a float64
    pull cast to the held float32; a name the scope lacks lands on the
    device of the tensors it holds (``meta`` here stands for the card) or
    on ``device=``; a held tensor of another shape, or of an integer dtype
    for a float value, raises at the pull, as does a new name in a scope
    with no tensor and no ``device``."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    scope = fluid.Scope()
    held = torch.zeros(3)
    scope.set("w", held)
    assert install_params(scope, {"w": np.arange(3, dtype=np.float32)}) \
        == ["w"]
    assert scope.find_var("w") is held and held.tolist() == [0, 1, 2]
    install_params(scope, {"w": np.full(3, 0.5)})            # float64
    assert scope.find_var("w") is held and held.dtype == torch.float32
    assert held.tolist() == [0.5, 0.5, 0.5]
    meta = fluid.Scope()
    meta.set("w", torch.zeros(3, device="meta"))
    install_params(meta, {"b": np.ones(2, np.float32)})
    assert meta.find_var("b").device.type == "meta"
    install_params(meta, {"c": np.ones(2, np.float32)}, device="cpu")
    assert meta.find_var("c").device.type == "cpu"
    with pytest.raises(ValueError, match="shape"):
        install_params(scope, {"w": np.ones(4, np.float32)})
    scope.set("n", torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        install_params(scope, {"n": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="device="):
        install_params(fluid.Scope(), {"w": np.ones(3, np.float32)})


def test_rpc_server_survives_client_dying_mid_handshake():
    """A client that connects and dies before the authkey challenge must
    not kill the accept loop — later clients still get served."""
    import socket

    ps, rpc = _start_ps(optimizer="sgd", mode="async")
    for _ in range(3):
        raw = socket.create_connection(rpc.address)
        raw.close()          # vanish mid-handshake
    c = RpcClient(rpc.address)
    assert "params" in c.call("stats")
    c.close()
    rpc.shutdown()


def test_parse_endpoint_tuple_passthrough():
    """Tuple/list endpoints get the same coercion as 'host:port' strings:
    int port, loopback default host, loud ValueError on a missing or
    non-numeric port."""
    from paddle_tpu_torch.distributed.param_server import parse_endpoint

    assert parse_endpoint(("10.0.0.1", "7164")) == ("10.0.0.1", 7164)
    assert parse_endpoint(["10.0.0.1", 7164]) == ("10.0.0.1", 7164)
    assert parse_endpoint(("", 7164)) == ("127.0.0.1", 7164)
    assert parse_endpoint(("h",), default_port=9) == ("h", 9)
    with pytest.raises(ValueError):
        parse_endpoint(("hostonly",))
    with pytest.raises(ValueError):
        parse_endpoint(("h", "notaport"))
    assert parse_endpoint("h:80") == ("h", 80)
    assert parse_endpoint(":80") == ("127.0.0.1", 80)


# ---------------------------------------------------------------------------
# lease-based sync-round membership (the elastic-trainer barrier contract)
# ---------------------------------------------------------------------------

def test_master_backlog_counts():
    """backlog(): cheap {pending, leased, failed} counts, ``failed`` the
    CUMULATIVE failure-event count (explicit fails + lease expiries)."""
    m, rpc = _start_master(timeout_s=0.3)
    c = MasterClient(rpc.address)
    c.set_dataset(["a", "b", "c", "d"])
    assert c.backlog() == {"pending": 4, "leased": 0, "failed": 0}
    t = c.get_task()
    assert c.backlog() == {"pending": 3, "leased": 1, "failed": 0}
    assert c.finished(t["task_id"], t["epoch"]) is True
    assert c.backlog() == {"pending": 3, "leased": 0, "failed": 0}
    t = c.get_task()
    assert c.failed(t["task_id"], t["epoch"]) is True
    assert c.backlog() == {"pending": 3, "leased": 0, "failed": 1}
    c.get_task()
    time.sleep(0.5)        # the lease's own clock runs out
    assert c.backlog() == {"pending": 3, "leased": 0, "failed": 2}
    c.close()
    rpc.shutdown()


def test_master_stale_fail_and_finish_after_redispatch_are_noops():
    """A task re-dispatched after its lease expired carries a bumped epoch,
    so the original holder's late finish/fail are no-ops."""
    m, rpc = _start_master(timeout_s=0.2)
    c = MasterClient(rpc.address)
    c.set_dataset(["a"])
    t_old = c.get_task()
    time.sleep(0.35)                      # the original lease expires
    t_new = c.get_task()                  # re-dispatched, epoch bumped
    assert t_new["task_id"] == t_old["task_id"]
    assert t_new["epoch"] > t_old["epoch"]
    assert c.failed(t_old["task_id"], t_old["epoch"]) is False
    assert c.finished(t_old["task_id"], t_old["epoch"]) is False
    assert c.backlog()["leased"] == 1
    assert c.finished(t_new["task_id"], t_new["epoch"]) is True
    assert c.progress()["done"] == 1
    c.close()
    rpc.shutdown()


def test_lease_barrier_shrinks_on_expired_member():
    """A sync round whose member dies mid-round SHRINKS at lease expiry and
    applies with the live members' gradients — it does not wait out the
    barrier timeout, and the round is never broken."""
    from paddle_tpu_torch.obs.recorder import RECORDER

    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="sync", fan_in=1, trainer_lease_s=0.6,
                        barrier_timeout_s=30.0)
    c1 = ParamClient([rpc.address], trainer_id="t1", param_names=["w"])
    c2 = ParamClient([rpc.address], trainer_id="t2", param_names=["w"])
    c1.init_params({"w": np.zeros(4, np.float32)})
    assert c1.register_trainer() == 0.6
    assert c2.register_trainer() == 0.6
    t = threading.Thread(target=lambda: c2.push(
        {"w": np.full(4, 3.0, np.float32)}))
    t.start()
    c1.push({"w": np.ones(4, np.float32)})
    t.join(JOIN_S)
    np.testing.assert_allclose(c1.pull()["w"], np.full(4, -2.0), rtol=1e-6)
    # t2 "dies": t1's next push completes at t2's lease expiry (~0.6 s)
    t0 = time.monotonic()
    c1.push({"w": np.ones(4, np.float32)})
    elapsed = time.monotonic() - t0
    assert elapsed < 5.0, f"barrier waited {elapsed:.1f}s (no shrink?)"
    np.testing.assert_allclose(c1.pull()["w"], np.full(4, -3.0), rtol=1e-6)
    st = RpcClient(rpc.address)
    s = st.call("stats")
    st.close()
    assert s["rounds_shrunk"] == 1
    assert s["rounds_broken"] == 0
    assert s["round"] == 2
    ev = [e for e in RECORDER.dump()["events"]
          if e["kind"] == "round_shrunk"
          and e["detail"].get("trainer_id") == "t2"]
    assert ev, "round_shrunk flight event must name the expired trainer"
    assert ev[-1]["detail"]["reason"] == "lease_expired"
    assert ev[-1]["detail"]["remaining"] == ["t1"]
    c1.close()
    c2.close()
    rpc.shutdown()


def test_lease_deregister_shrinks_immediately():
    """Graceful leave: deregister_trainer drops the member from the open
    round's barrier NOW."""
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="sync", fan_in=1, trainer_lease_s=30.0,
                        barrier_timeout_s=60.0)
    c1 = ParamClient([rpc.address], trainer_id="t1", param_names=["w"])
    c2 = ParamClient([rpc.address], trainer_id="t2", param_names=["w"])
    c1.init_params({"w": np.zeros(2, np.float32)})
    c1.register_trainer()
    c2.register_trainer()
    done = threading.Event()

    def push_one():
        c1.push({"w": np.ones(2, np.float32)})
        done.set()

    threading.Thread(target=push_one, daemon=True).start()
    assert not done.wait(0.3)         # the barrier waits on t2 (30 s lease)
    assert c2.deregister_trainer() is True
    assert done.wait(5.0), "deregister must release the barrier"
    s = RpcClient(rpc.address)
    stats = s.call("stats")
    s.close()
    assert stats["rounds_shrunk"] == 1
    assert stats["rounds_broken"] == 0
    assert "t2" not in stats["trainer_leases"]
    c1.close()
    c2.close()
    rpc.shutdown()


def test_stale_push_old_seq_after_membership_change_is_noop():
    """After a trainer's rounds have advanced (and membership churned), a
    late replay of one of its old seqs is answered from the dedup path
    without re-applying or disturbing the round."""
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="sync", fan_in=1, trainer_lease_s=5.0)
    c1 = ParamClient([rpc.address], trainer_id="t1", param_names=["w"])
    c1.init_params({"w": np.zeros(4, np.float32)})
    c1.register_trainer()
    seq0 = c1.allocate_seq()
    c1.push({"w": np.ones(4, np.float32)}, seq=seq0)       # round 1
    c2 = ParamClient([rpc.address], trainer_id="t2", param_names=["w"])
    c2.register_trainer()
    t = threading.Thread(target=lambda: c2.push(
        {"w": np.ones(4, np.float32)}))
    t.start()
    c1.push({"w": np.ones(4, np.float32)})
    t.join(JOIN_S)
    np.testing.assert_allclose(c1.pull()["w"], np.full(4, -2.0), rtol=1e-6)
    direct = RpcClient(rpc.address)
    direct.call("push", grads={"w": np.ones(4, np.float32)},
                trainer_id="t1", seq=seq0)
    s = direct.call("stats")
    direct.close()
    assert s["round"] == 2                      # no new round opened
    np.testing.assert_allclose(c1.pull()["w"], np.full(4, -2.0), rtol=1e-6)
    c1.close()
    c2.close()
    rpc.shutdown()


def test_join_opens_membership_at_one_round_on_every_shard():
    """A trainer that registers between two shards' round-opens (shard
    A's round 0 open, shard B's not yet) is a member from the same round
    on both: its first push waits for round 1 on each, and the shards'
    rounds stay equal to the end. With the one-phase registration it
    would be a member of B's round 0 and not of A's, and A's counter
    would end one round ahead: a torn cut."""
    psa, a = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                       mode="sync", fan_in=1, trainer_lease_s=30.0,
                       barrier_timeout_s=30.0)
    psb, b = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                       mode="sync", fan_in=1, trainer_lease_s=30.0,
                       barrier_timeout_s=30.0)
    c1, c2, c3 = (ParamClient([a.address, b.address], trainer_id=t,
                              param_names=["a", "b"])
                  for t in ("t1", "t2", "t3"))
    assert shard_names(["a", "b"], 2) == [["a"], ["b"]]
    one = np.ones(2, np.float32)
    c1.init_params({"a": np.zeros(2, np.float32),
                    "b": np.zeros(2, np.float32)})
    c1.register_trainer()
    c2.register_trainer()

    def run(*fns):
        ts = [threading.Thread(target=f) for f in fns]
        for t in ts:
            t.start()
        return ts

    s1, s2 = c1.allocate_seq(), c2.allocate_seq()
    first = run(lambda: c1.push({"a": one}, seq=s1))
    _wait_until(lambda: psa.stats()["round_members"] is not None, 10.0,
                "shard A's round 0 to open")
    c3.register_trainer()                # between the two round-opens
    joiner = run(lambda: c3.push({"a": one, "b": one}))
    first += run(lambda: c2.push({"a": one}, seq=s2),
                 lambda: c1.push({"b": one}, seq=s1),
                 lambda: c2.push({"b": one}, seq=s2))
    for t in first:
        t.join(JOIN_S)
    assert psa.stats()["round"] == psb.stats()["round"] == 1
    _wait_until(lambda: all(p.stats()["round_members"] == ["t1", "t2", "t3"]
                            for p in (psa, psb)), 10.0,
                "round 1 to open with the joiner on both shards")
    for t in run(lambda: c1.push({"a": one, "b": one}),
                 lambda: c2.push({"a": one, "b": one})) + joiner:
        t.join(JOIN_S)
    c1.deregister_trainer()
    c2.deregister_trainer()
    c3.push({"a": one, "b": one})
    assert psa.stats()["round"] == psb.stats()["round"] == 3
    rounds = c3.snapshot_prepare("cut")
    c3.snapshot_release("cut", wait=True)
    assert rounds == {0: 3, 1: 3}
    got = c3.pull()
    np.testing.assert_array_equal(got["a"], np.full(2, -3.0, np.float32))
    np.testing.assert_array_equal(got["b"], got["a"])
    for c in (c1, c2, c3):
        c.close()
    a.shutdown()
    b.shutdown()


def test_lease_counts_from_the_round_close_for_its_pushers():
    """A member blocked at the barrier is not idle: when the round
    closes, the leases of its pushers start afresh, so a wait on a slow
    peer does not age them out of the next round."""
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="sync", fan_in=1, trainer_lease_s=2.0,
                        barrier_timeout_s=30.0)
    c1 = ParamClient([rpc.address], trainer_id="t1", param_names=["w"])
    c2 = ParamClient([rpc.address], trainer_id="t2", param_names=["w"])
    c1.init_params({"w": np.zeros(2, np.float32)})
    c1.register_trainer()
    c2.register_trainer()
    t = threading.Thread(target=lambda: c1.push(
        {"w": np.ones(2, np.float32)}))
    t.start()
    _wait_until(lambda: ps.stats()["round_members"] is not None, 10.0,
                "the round to open")
    time.sleep(0.8)                  # t1 waits at the barrier this long
    c2.push({"w": np.ones(2, np.float32)})
    t.join(JOIN_S)
    left = ps.stats()["trainer_leases"]
    assert left["t1"] > 1.5, left    # from the close, not from its push
    c1.close()
    c2.close()
    rpc.shutdown()


def _read_report(path):
    import json
    with open(path) as f:
        return json.load(f)


def test_elastic_fleet_sigkill_and_hot_join_chaos(tmp_path):
    """3 sync trainers (2 workers + 1 victim) against 2 lease-mode pserver
    shards and a Master queue. The victim is SIGKILLed mid-round while
    holding a task lease; a 4th trainer hot-joins after the kill. ZERO lost
    chunks, balanced Master accounting, no broken rounds (they SHRINK),
    equal rounds across shards, and the flight recorder names the dead
    trainer."""
    from paddle_tpu_torch.obs.recorder import RECORDER

    # pserver leases of 1.5 s and master leases of 5 s (the reference's
    # test: 0.8 and 1): a live worker that a loaded host starves past its
    # pserver lease between two pushes is shrunk out of a round on one
    # shard and not on the other, which tears the cut. (A registration
    # between two shards' round-opens no longer can: the client joins in
    # two phases.) The pserver lease stays the shorter: a worker blocked
    # on the victim keeps its task
    m, m_rpc = _start_master(timeout_s=5.0)
    c = MasterClient(m_rpc.address)
    chunks = [f"c{i}" for i in range(10)]
    c.set_dataset(chunks)
    _psa, rpc_a = _start_ps(optimizer="sgd", opt_kwargs={"lr": 0.02},
                            mode="sync", fan_in=1, trainer_lease_s=1.5,
                            barrier_timeout_s=25.0)
    _psb, rpc_b = _start_ps(optimizer="sgd", opt_kwargs={"lr": 0.02},
                            mode="sync", fan_in=1, trainer_lease_s=1.5,
                            barrier_timeout_s=25.0)
    ps_addrs = [list(rpc_a.address), list(rpc_b.address)]
    pc0 = ParamClient([rpc_a.address, rpc_b.address])
    pc0.init_params({"a": np.zeros(4, np.float32),
                     "b": np.zeros(4, np.float32)})
    outs = {t: str(tmp_path / f"{t}.json") for t in ("w1", "w2", "w3")}
    gate, go = str(tmp_path / "gate"), str(tmp_path / "join")
    addrs = (list(m_rpc.address), ps_addrs)
    t0 = time.monotonic()
    # the first three register, each holding a task, before any pushes;
    # the joiner's interpreter starts now and waits for ``go``, so it
    # joins right after the kill, while both shards' open rounds still
    # wait on the dead victim's lease (as the reference's forked joiner)
    victim = spawn_child(elastic.elastic_sync_victim,
                         (*addrs, "victim", gate))
    workers = [spawn_child(elastic.elastic_sync_worker,
                           (*addrs, t, outs[t], None, gate))
               for t in ("w1", "w2")]
    joiner = spawn_child(elastic.elastic_sync_worker,
                         (*addrs, "w3", outs["w3"], go))
    procs = [victim, *workers, joiner]
    try:
        first = {"victim", "w1", "w2"}
        _wait_until(lambda: all(first <= set(s.stats()["trainer_leases"])
                                for s in (_psa, _psb)), 30.0,
                    "the first members")
        open(gate, "w").close()
        # the victim is mid-lease and mid-rounds when it dies
        _wait_until(lambda: all(s.stats()["round"] >= 2
                                for s in (_psa, _psb)), 30.0, "two rounds")
        victim.kill()
        victim.join(JOIN_S)
        open(go, "w").close()        # hot-join AFTER the kill
        for p in (*workers, joiner):
            p.join(JOIN_S)
        assert not any(p.is_alive() for p in procs)
    finally:
        for p in procs:
            p.kill()
            p.join(JOIN_S)
    elapsed = time.monotonic() - t0
    reports = {t: _read_report(o)["processed"] for t, o in outs.items()}
    seen = sorted(set(sum(reports.values(), [])))
    assert seen == chunks, f"lost chunks: {set(chunks) - set(seen)}"
    assert c.progress() == {"todo": 0, "doing": 0, "done": 10,
                            "pass_id": 1}
    assert c.backlog() == {"pending": 0, "leased": 0, "failed": 1}
    assert elapsed < 25.0, f"elastic drain took {elapsed:.1f}s"
    rounds = pc0.snapshot_prepare("post-chaos")
    pc0.snapshot_release("post-chaos", wait=True)
    assert len(set(rounds.values())) == 1, f"torn: {rounds}"
    for rpc in (rpc_a, rpc_b):
        s_cli = RpcClient(rpc.address)
        s = s_cli.call("stats")
        s_cli.close()
        assert s["rounds_broken"] == 0
        assert s["rounds_shrunk"] >= 1
        assert s["trainer_leases"] == {}     # everyone left or expired
    p = pc0.pull()
    w = np.concatenate([p["a"], p["b"]])
    assert np.all(np.isfinite(w))
    w_true = elastic.elastic_w_true()
    assert np.linalg.norm(w - w_true) < np.linalg.norm(w_true)
    assert any(e["kind"] == "round_shrunk"
               and e["detail"].get("trainer_id") == "victim"
               for e in RECORDER.dump()["events"])
    pc0.close()
    c.close()
    m_rpc.shutdown()
    rpc_a.shutdown()
    rpc_b.shutdown()


def test_lease_holders_survive_checkpoint_restore(tmp_path):
    """A restarted shard re-opens rounds with the SAME membership as its
    peers: the checkpoint persists lease HOLDERS and restore re-grants
    them a fresh ttl."""
    path = str(tmp_path / "ps.ckpt")
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="sync", fan_in=1, trainer_lease_s=5.0,
                        checkpoint_path=path, checkpoint_every=1)
    c1 = ParamClient([rpc.address], trainer_id="t1", param_names=["w"])
    c2 = ParamClient([rpc.address], trainer_id="t2", param_names=["w"])
    c1.init_params({"w": np.zeros(4, np.float32)})
    c1.register_trainer()
    c2.register_trainer()
    t = threading.Thread(target=lambda: c2.push(
        {"w": np.full(4, 3.0, np.float32)}))
    t.start()
    c1.push({"w": np.ones(4, np.float32)})   # round 1 applies, ckpt due
    t.join(JOIN_S)
    c1.close()
    c2.close()
    rpc.shutdown()

    ps2, rpc2 = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                          mode="sync", fan_in=1, trainer_lease_s=5.0,
                          checkpoint_path=path, checkpoint_every=1)
    st = RpcClient(rpc2.address)
    s = st.call("stats")
    assert sorted(s["trainer_leases"]) == ["t1", "t2"]
    assert s["round"] == 1
    d1 = RpcClient(rpc2.address)
    done = threading.Event()

    def _push1():
        d1.call("push", grads={"w": np.ones(4, np.float32)},
                trainer_id="t1", seq=2)
        done.set()

    threading.Thread(target=_push1, daemon=True).start()
    assert not done.wait(0.4), \
        "lone push applied instantly: restored lease not a round member"
    d2 = RpcClient(rpc2.address)
    d2.call("push", grads={"w": np.full(4, 3.0, np.float32)},
            trainer_id="t2", seq=2)
    assert done.wait(5.0)
    pull = RpcClient(rpc2.address)
    np.testing.assert_allclose(pull.call("pull")["w"], np.full(4, -4.0),
                               rtol=1e-6)
    pull.close()
    st.close()
    d1.close()
    d2.close()
    rpc2.shutdown()


def test_server_numpy_only_in_a_fresh_interpreter(tmp_path):
    """A child started by spawn_child (how PserverSupervisor starts its
    shards) imports numpy and distributed/, never torch."""
    out = str(tmp_path / "torch.json")
    child = spawn_child(elastic.torch_loaded, (out,))
    child.join(JOIN_S)
    assert child.exitcode == 0
    assert _read_report(out) == {"torch": False}


# ---------------------------------------------------------------------------
# the launcher and the supervisors' fleet surface
# ---------------------------------------------------------------------------

_RANK_SCRIPT = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from paddle_tpu_torch.parallel.multihost import init_multihost
info = init_multihost(backend="gloo")
t = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(t)
print(f"rank {info['process_index']} of {info['process_count']} sum "
      f"{t.item():.0f} local {os.environ['LOCAL_RANK']}")
dist.destroy_process_group()
"""


def test_launch_wires_the_ranks_through_env(tmp_path, capsys):
    """launch(script) starts nproc copies as the ranks of one gloo group
    (env://), drains their output with a rank prefix and returns their
    exit codes; a rank that outlives the timeout is killed."""
    from paddle_tpu_torch.distributed.launch import launch, main

    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert launch(str(script), [repo], nproc=2, timeout=120) == [0, 0]
    out = capsys.readouterr().out
    for r in (0, 1):
        assert f"[rank {r}] rank {r} of 2 sum 3 local {r}" in out, out
    hang = tmp_path / "hang.py"
    hang.write_text("import time\ntime.sleep(60)\n")
    assert main(["--nproc", "1", "--timeout", "1", str(hang)]) != 0


def test_supervisor_grows_shrinks_and_gives_up_on_a_crash_loop(tmp_path):
    """add_child starts one more shard on a fresh fixed address and
    retire_child stops the highest one; a child killed more than
    max_restarts times is given up (gave_up in child_stats)."""
    from paddle_tpu_torch.distributed import PserverSupervisor

    with PserverSupervisor(n_servers=1, checkpoint_dir=str(tmp_path),
                           heartbeat_interval_s=0.1,
                           max_restarts=1) as sup:
        assert sup.wait_ready(30.0)
        addr = sup.add_child()
        assert sup.n_children == 2 and tuple(sup.addresses[1]) == addr
        assert sup.wait_ready(30.0)
        c = RpcClient(addr)
        assert c.call("stats")["params"] == []
        c.close()
        assert sup.retire_child() == addr
        assert sup.n_children == 1
        sup.kill(0)
        _wait_until(lambda: sup.restarts[0] == 1 and sup.child_alive(0),
                    30.0, "the restart")
        sup.kill(0)
        _wait_until(lambda: sup.child_stats()[0]["gave_up"], 30.0,
                    "giving up")
        st = sup.child_stats()[0]
        assert st["restart_count"] == 1 and not st["alive"]
        assert st["last_restart_reason"].startswith("exited code")
