"""The port's parameter-server wire path: the counterparts of
tests/test_pserver_wire.py that tests/test_torch_rpc.py does not already
hold (the codec round trip, frame sizes, the answering codec, the
rpc_timeout_s flag on a bare client and the bare server's counters are
there): sparse pushes and their O(touched rows) bytes, rowwise Adam
laziness, sparse checkpoints bitwise, sync-round merges, the fp16 wire,
the pull fan-out's errors and concurrency, the flag through ParamClient
and the supervisor's heartbeat, and a shard's wire counters and spans.

Then across packages, both ways: a port client trains against a reference
server and a reference client against a port server, to the same
parameters as one package alone; a checkpoint of either package's server
restores into the other's bitwise (both are plain pickles of numpy
state), and both go on bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.distributed import (ParameterServer, ParamClient,
                                          serve, SparseGrad, FaultPlan)


def _start_ps(**kw):
    ps, rpc = serve(**kw)
    rpc.serve_in_thread()
    return ps, rpc


# ---------------------------------------------------------------------------
# sparse push: O(touched rows) wire + rowwise server-side apply
# ---------------------------------------------------------------------------

def test_sparse_push_matches_dense_sgd():
    """A SparseGrad push (duplicate ids the server must merge) lands
    exactly like the equivalent dense gradient."""
    table0 = np.random.RandomState(0).normal(
        size=(10, 4)).astype(np.float32)
    rows = np.array([3, 1, 3], np.int64)
    vals = np.array([[1, 1, 1, 1], [2, 2, 2, 2], [4, 4, 4, 4]], np.float32)
    dense = np.zeros_like(table0)
    np.add.at(dense, rows, vals)
    ps_d = ParameterServer(optimizer="sgd", opt_kwargs={"lr": 0.1})
    ps_d.init_params({"emb": table0})
    ps_d.push({"emb": dense}, trainer_id=0, seq=1)
    ps_s = ParameterServer(optimizer="sgd", opt_kwargs={"lr": 0.1})
    ps_s.init_params({"emb": table0})
    ps_s.push({"emb": SparseGrad(rows, vals, nrows=10)}, trainer_id=0,
              seq=1)
    np.testing.assert_allclose(ps_s.pull()["emb"], ps_d.pull()["emb"],
                               rtol=1e-6)
    untouched = [i for i in range(10) if i not in (1, 3)]
    np.testing.assert_array_equal(ps_s.pull()["emb"][untouched],
                                  table0[untouched])


def test_sparse_push_rowwise_adam_state_and_laziness():
    """Rowwise Adam: m1/m2/t update only for touched rows (per-row t),
    untouched rows keep zero state and do not move."""
    table0 = np.ones((6, 3), np.float32)
    ps = ParameterServer(optimizer="adam", opt_kwargs={"lr": 0.01})
    ps.init_params({"emb": table0})
    g = SparseGrad(np.array([0, 2], np.int64),
                   np.ones((2, 3), np.float32), nrows=6)
    ps.push({"emb": g}, trainer_id=0, seq=1)
    ps.push({"emb": g}, trainer_id=0, seq=2)
    st = ps._opt_state["emb"]
    np.testing.assert_array_equal(st["t"], [2, 0, 2, 0, 0, 0])
    assert st["m1"][[1, 3, 4, 5]].sum() == 0.0
    assert np.abs(st["m1"][[0, 2]]).min() > 0
    w = ps.pull()["emb"]
    np.testing.assert_array_equal(w[[1, 3, 4, 5]], table0[[1, 3, 4, 5]])
    assert np.abs(w[[0, 2]] - table0[[0, 2]]).min() > 1e-4


def test_sparse_rowwise_state_checkpoints_bitwise(tmp_path):
    """Rowwise m1/m2/t persist and restore bitwise, and the restored
    server continues bit-identically through further sparse pushes."""
    path = str(tmp_path / "ps.ckpt")
    rng = np.random.RandomState(1)
    ps = ParameterServer(optimizer="adam", opt_kwargs={"lr": 0.01},
                         mode="async")
    ps.init_params({"emb": rng.normal(size=(8, 3)).astype(np.float32)})
    for s in range(1, 4):
        g = SparseGrad(rng.randint(0, 8, size=(4,)),
                       rng.normal(size=(4, 3)).astype(np.float32), nrows=8)
        ps.push({"emb": g}, trainer_id=1, seq=s)
    ps.save_checkpoint(path)
    ps2 = ParameterServer(optimizer="adam", opt_kwargs={"lr": 0.01},
                          mode="async")
    assert ps2.restore(path) is True
    for k in ("m1", "m2", "t"):
        np.testing.assert_array_equal(ps._opt_state["emb"][k],
                                      ps2._opt_state["emb"][k])
    before = np.array(ps2.pull()["emb"], copy=True)
    ps2.push({"emb": SparseGrad(np.array([0]), np.ones((1, 3), np.float32),
                                nrows=8)}, trainer_id=1, seq=3)
    np.testing.assert_array_equal(ps2.pull()["emb"], before)
    g4 = SparseGrad(np.array([2, 5]),
                    rng.normal(size=(2, 3)).astype(np.float32), nrows=8)
    ps.push({"emb": g4}, trainer_id=1, seq=4)
    ps2.push({"emb": g4}, trainer_id=1, seq=4)
    np.testing.assert_array_equal(ps.pull()["emb"], ps2.pull()["emb"])


def test_sync_round_merges_sparse_pushes_across_trainers():
    table0 = np.zeros((5, 2), np.float32)
    ps = ParameterServer(optimizer="sgd", opt_kwargs={"lr": 1.0},
                         mode="sync", fan_in=2)
    ps.init_params({"emb": table0})
    g1 = SparseGrad(np.array([0, 2]), np.ones((2, 2), np.float32), nrows=5)
    g2 = SparseGrad(np.array([2, 4]),
                    2 * np.ones((2, 2), np.float32), nrows=5)
    t = threading.Thread(target=lambda: ps.push({"emb": g1}, trainer_id=0,
                                                seq=1))
    t.start()
    ps.push({"emb": g2}, trainer_id=1, seq=1)
    t.join(30.0)
    expect = np.zeros((5, 2), np.float32)
    expect[0] -= 1.0 / 2
    expect[2] -= (1.0 + 2.0) / 2
    expect[4] -= 2.0 / 2
    np.testing.assert_allclose(ps.pull()["emb"], expect, rtol=1e-6)


def test_sync_round_mixing_dense_and_sparse_for_one_param():
    ps = ParameterServer(optimizer="sgd", opt_kwargs={"lr": 1.0},
                         mode="sync", fan_in=2)
    ps.init_params({"emb": np.zeros((4, 2), np.float32)})
    sparse = SparseGrad(np.array([1]), np.ones((1, 2), np.float32), nrows=4)
    dense = np.full((4, 2), 2.0, np.float32)
    t = threading.Thread(target=lambda: ps.push({"emb": sparse},
                                                trainer_id=0, seq=1))
    t.start()
    ps.push({"emb": dense}, trainer_id=1, seq=1)
    t.join(30.0)
    expect = -(dense + sparse.to_dense()) / 2
    np.testing.assert_allclose(ps.pull()["emb"], expect, rtol=1e-6)


def test_param_client_converts_core_sparse_rows():
    """A trainer pushing the port executor's own SparseRows (torch
    tensors, sentinel padding == nrows) ships only the real touched rows,
    and the server's result matches the densified gradient."""
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="async")
    c = ParamClient([rpc.address], trainer_id=0)
    nrows, dim = 512, 8
    table0 = np.zeros((nrows, dim), np.float32)
    c.init_params({"emb": table0})
    sr = SparseRows(torch.tensor([1, 4, 1, nrows, nrows]),
                    torch.ones(5, dim), nrows=nrows)
    sent0 = c.wire_stats()["bytes_sent"]
    c.push({"emb": sr})
    pushed_bytes = c.wire_stats()["bytes_sent"] - sent0
    assert pushed_bytes < 2000 < table0.nbytes
    expect = np.zeros((nrows, dim), np.float32)
    expect[1] -= 2.0
    expect[4] -= 1.0
    np.testing.assert_allclose(c.pull()["emb"], expect, rtol=1e-6)
    c.close()
    rpc.shutdown()


def test_dense_torch_grads_leave_as_numpy():
    """A dense gradient handed over as a torch tensor (a fetch with
    return_numpy=False) goes on the wire as numpy; a bfloat16 one as
    float32."""
    c = ParamClient([("127.0.0.1", 1)])
    g = c._wire_grad("w", torch.ones(3, 2))
    assert isinstance(g, np.ndarray) and g.dtype == np.float32
    g = c._wire_grad("w", torch.ones(3, dtype=torch.bfloat16))
    assert isinstance(g, np.ndarray) and g.dtype == np.float32


def test_sparse_push_bytes_scale_with_touched_rows():
    ps, rpc = _start_ps(optimizer="sgd", mode="async")
    c = ParamClient([rpc.address], trainer_id=0)
    dim, nrows = 16, 4096
    c.init_params({"emb": np.zeros((nrows, dim), np.float32)})

    def push_bytes(k):
        g = SparseGrad(np.arange(k, dtype=np.int64),
                       np.ones((k, dim), np.float32), nrows=nrows,
                       merged=True)
        before = c.wire_stats()["bytes_sent"]
        c.push({"emb": g})
        return c.wire_stats()["bytes_sent"] - before

    b64, b512 = push_bytes(64), push_bytes(512)
    assert 6.0 < b512 / b64 < 9.0
    assert b512 < nrows * dim * 4 / 2
    c.close()
    rpc.shutdown()


def test_marked_param_sparsifies_densified_grads_on_the_wire():
    nrows, dim = 1024, 16
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="async")
    c = ParamClient([rpc.address], trainer_id=0,
                    sparse_param_names=["emb"])
    c.init_params({"emb": np.zeros((nrows, dim), np.float32)})
    dense = np.zeros((nrows, dim), np.float32)
    dense[3] = 1.0
    dense[700] = 2.0
    before = c.wire_stats()["bytes_sent"]
    c.push({"emb": dense})
    pushed = c.wire_stats()["bytes_sent"] - before
    assert pushed < 2000 < dense.nbytes
    np.testing.assert_allclose(c.pull()["emb"], -dense, rtol=1e-6)
    assert isinstance(c._wire_grad("other", dense), np.ndarray)
    assert isinstance(c._wire_grad("emb", np.ones((4, 2), np.float32)),
                      np.ndarray)
    c.close()
    rpc.shutdown()


def test_pull_copies_only_params_with_sparse_history():
    ps = ParameterServer(optimizer="sgd", opt_kwargs={"lr": 1.0})
    ps.init_params({"w": np.zeros(4, np.float32),
                    "emb": np.zeros((4, 2), np.float32)})
    assert ps.pull()["w"] is ps._params["w"]
    held = ps.pull()["emb"]
    ps.push({"emb": SparseGrad(np.array([1]),
                               np.ones((1, 2), np.float32), nrows=4)},
            trainer_id=0, seq=1)
    np.testing.assert_array_equal(held, np.zeros((4, 2), np.float32))
    got = ps.pull()["emb"]
    assert got is not ps._params["emb"]
    np.testing.assert_array_equal(got[1], [-1.0, -1.0])


# ---------------------------------------------------------------------------
# fp16 wire dtype
# ---------------------------------------------------------------------------

def test_fp16_wire_halves_push_bytes_and_accumulates_fp32():
    old = flags.get_flag("pserver_wire_dtype")
    ps, rpc = _start_ps(optimizer="sgd", opt_kwargs={"lr": 1.0},
                        mode="async")
    c = ParamClient([rpc.address], trainer_id=0)
    g = np.random.RandomState(0).normal(size=(256, 64)).astype(np.float32)
    c.init_params({"w": np.zeros_like(g)})
    try:
        before = c.wire_stats()["bytes_sent"]
        c.push({"w": g})
        fp32_bytes = c.wire_stats()["bytes_sent"] - before
        flags.set_flags({"pserver_wire_dtype": "fp16"})
        before = c.wire_stats()["bytes_sent"]
        c.push({"w": g})
        fp16_bytes = c.wire_stats()["bytes_sent"] - before
        assert fp16_bytes < 0.6 * fp32_bytes
        got = c.pull()["w"]
        assert got.dtype == np.float32
        np.testing.assert_allclose(
            got, -(g + g.astype(np.float16).astype(np.float32)),
            rtol=1e-6)
    finally:
        flags.set_flags({"pserver_wire_dtype": old})
        c.close()
        rpc.shutdown()


def test_fp16_wire_applies_to_sparse_values():
    old = flags.get_flag("pserver_wire_dtype")
    ps = ParameterServer(optimizer="sgd", opt_kwargs={"lr": 1.0})
    ps.init_params({"emb": np.zeros((4, 2), np.float32)})
    try:
        flags.set_flags({"pserver_wire_dtype": "fp16"})
        sg = ParamClient([("127.0.0.1", 1)])._wire_grad(
            "emb", SparseGrad(np.array([1]),
                              np.full((1, 2), 0.1, np.float32), nrows=4))
        assert sg.values.dtype == np.float16
        ps.push({"emb": sg}, trainer_id=0, seq=1)
        assert ps.pull()["emb"].dtype == np.float32
        np.testing.assert_allclose(
            ps.pull()["emb"][1],
            -np.full((2,), 0.1, np.float16).astype(np.float32))
    finally:
        flags.set_flags({"pserver_wire_dtype": old})


def test_wire_dtype_flag_refuses_other_values():
    old = flags.get_flag("pserver_wire_dtype")
    try:
        flags.set_flags({"pserver_wire_dtype": "bf16"})
        with pytest.raises(ValueError, match="fp32' or 'fp16"):
            ParamClient([("127.0.0.1", 1)], param_names=["w"]).push(
                {"w": np.ones(2, np.float32)})
    finally:
        flags.set_flags({"pserver_wire_dtype": old})
    assert old == "fp32"                                  # the reference's


# ---------------------------------------------------------------------------
# parallel pull + error aggregation
# ---------------------------------------------------------------------------

def test_pull_fans_out_and_aggregates_all_shard_errors():
    ps1, rpc1 = _start_ps(optimizer="sgd")
    ps2, rpc2 = _start_ps(optimizer="sgd")
    c = ParamClient([rpc1.address, rpc2.address], trainer_id=1)
    params = {f"p{i}": np.full((2,), float(i), np.float32)
              for i in range(4)}
    c.init_params(params)
    got = c.pull()
    for i in range(4):
        np.testing.assert_array_equal(got[f"p{i}"], params[f"p{i}"])
    rpc1.kill()
    rpc2.kill()
    with pytest.raises(RuntimeError) as ei:
        c.pull()
    msg = str(ei.value)
    assert "shard 0" in msg and "shard 1" in msg, msg
    c.close()


def test_pull_single_shard_error_keeps_original_type():
    ps1, rpc1 = _start_ps(optimizer="sgd")
    ps2, rpc2 = _start_ps(optimizer="sgd")
    c = ParamClient([rpc1.address, rpc2.address], trainer_id=1)
    c.init_params({f"p{i}": np.zeros(2, np.float32) for i in range(4)})
    rpc2.kill()
    with pytest.raises((EOFError, ConnectionError, OSError)):
        c.pull()
    c.close()
    rpc1.shutdown()


def test_pull_runs_shards_concurrently():
    """A slow shard overlaps with the other: pull wall time is
    max(shards), not their sum."""
    delay = 0.4
    ps1, rpc1 = _start_ps(optimizer="sgd",
                          fault_plan=FaultPlan().delay("pull", 0, delay))
    ps2, rpc2 = _start_ps(optimizer="sgd",
                          fault_plan=FaultPlan().delay("pull", 0, delay))
    c = ParamClient([rpc1.address, rpc2.address], trainer_id=1)
    c.init_params({f"p{i}": np.zeros(2, np.float32) for i in range(4)})
    t0 = time.monotonic()
    c.pull()
    dt = time.monotonic() - t0
    assert dt < 2 * delay * 0.95, f"pull took {dt:.3f}s — sequential?"
    c.close()
    rpc1.shutdown()
    rpc2.shutdown()


def test_sync_fan_in_accumulation_does_not_mutate_caller_arrays():
    ps = ParameterServer(optimizer="sgd", opt_kwargs={"lr": 1.0},
                         mode="sync", fan_in=2)
    ps.init_params({"w": np.zeros(3, np.float32)})
    g = np.ones(3, np.float32)          # SAME array pushed by both
    t = threading.Thread(target=lambda: ps.push({"w": g}, trainer_id=0,
                                                seq=1))
    t.start()
    ps.push({"w": g}, trainer_id=1, seq=1)
    t.join(30.0)
    np.testing.assert_array_equal(g, np.ones(3, np.float32))
    np.testing.assert_array_equal(ps.pull()["w"], -np.ones(3, np.float32))


# ---------------------------------------------------------------------------
# the rpc_timeout_s flag through ParamClient and the supervisor
# ---------------------------------------------------------------------------

def test_rpc_timeout_flag_threads_through_param_clients():
    old = flags.get_flag("rpc_timeout_s")
    try:
        flags.set_flags({"rpc_timeout_s": 0.5})
        pc = ParamClient([("127.0.0.1", 1)])
        assert all(c._timeout == 0.5 for c in pc._clients)
        pc = ParamClient([("127.0.0.1", 1)], rpc_timeout=2.0)
        assert all(c._timeout == 2.0 for c in pc._clients)
    finally:
        flags.set_flags({"rpc_timeout_s": old})


def test_supervisor_heartbeat_timeout_follows_flag():
    from paddle_tpu_torch.distributed import PserverSupervisor

    old = flags.get_flag("rpc_timeout_s")
    try:
        flags.set_flags({"rpc_timeout_s": 0.75})
        sup = PserverSupervisor(n_servers=1)
        try:
            assert sup._hb_timeout == 0.75
        finally:
            sup.stop()
    finally:
        flags.set_flags({"rpc_timeout_s": old})


def test_wire_counters_surface_in_pserver_stats_and_client():
    ps, rpc = _start_ps(optimizer="sgd", mode="async")
    c = ParamClient([rpc.address], trainer_id=0)
    c.init_params({"w": np.zeros((32, 8), np.float32)})
    c.push({"w": np.ones((32, 8), np.float32)})
    c.pull()
    # the server notes a call after sending its reply: poll it in
    deadline = time.monotonic() + 5.0
    st = ps.stats()
    while "pull" not in st["wire"]["calls"] \
            and time.monotonic() < deadline:
        time.sleep(0.01)
        st = ps.stats()
    assert st["wire"]["bytes_recv"] > 32 * 8 * 4
    assert st["wire"]["calls"]["push"]["count"] == 1
    assert st["wire"]["calls"]["pull"]["count"] == 1
    cs = c.wire_stats()
    assert cs["bytes_sent"] > 32 * 8 * 4
    assert cs["calls"]["pull"]["count"] == 1
    assert cs["calls"]["pull"]["total_s"] > 0
    c.close()
    rpc.shutdown()


def test_pserver_calls_record_profiler_spans():
    from paddle_tpu_torch.core import profiler

    ps, rpc = _start_ps(optimizer="sgd", mode="async")
    c = ParamClient([rpc.address], trainer_id=0)
    profiler.enable_profiler()
    try:
        c.init_params({"w": np.zeros(4, np.float32)})
        c.push({"w": np.ones(4, np.float32)})
        rows = profiler.disable_profiler(sorted_key="total")
    finally:
        c.close()
        rpc.shutdown()
    names = {r["name"] for r in rows}
    assert "rpc.client/push" in names
    assert "rpc.client/init_params" in names


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _train_through(server_mod, client_mod, opt, seed=3, steps=4):
    """Two shards of ``server_mod``'s ParameterServer (sync, fan_in 1),
    trained through ``client_mod``'s ParamClient with dense and sparse
    pushes; returns the pulled params after each step."""
    rng = np.random.RandomState(seed)
    params = {"emb": rng.normal(size=(20, 4)).astype(np.float32),
              "w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": np.zeros(3, np.float32)}
    servers = [server_mod.serve(optimizer=opt, opt_kwargs={"lr": 0.05},
                                mode="sync") for _ in range(2)]
    for _, rpc in servers:
        rpc.serve_in_thread()
    c = client_mod.ParamClient([rpc.address for _, rpc in servers],
                               trainer_id=0)
    out = []
    try:
        c.init_params(params)
        for _ in range(steps):
            rows = rng.randint(0, 20, size=(6,))
            sparse = client_mod.SparseGrad(
                rows, rng.normal(size=(6, 4)).astype(np.float32), nrows=20)
            c.push({"emb": sparse,
                    "w": rng.normal(size=(4, 3)).astype(np.float32),
                    "b": rng.normal(size=(3,)).astype(np.float32)})
            out.append(c.pull())
    finally:
        c.close()
        for _, rpc in servers:
            rpc.shutdown()
    return out


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_port_client_and_reference_server_both_ways(opt):
    """Port client -> reference server and reference client -> port
    server train to the parameters of either package alone, bitwise (the
    rules are the same numpy, and the wire is the same bytes)."""
    import paddle_tpu.distributed as jdist
    import paddle_tpu_torch.distributed as tdist

    port = _train_through(tdist, tdist, opt)
    for got in (_train_through(jdist, tdist, opt),
                _train_through(tdist, jdist, opt),
                _train_through(jdist, jdist, opt)):
        for a, b in zip(got, port):
            assert sorted(a) == sorted(b)
            for n in a:
                np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def _pushes(rng, n):
    return [(rng.randint(0, 8, size=(4,)),
             rng.normal(size=(4, 3)).astype(np.float32),
             rng.normal(size=(3,)).astype(np.float32)) for _ in range(n)]


def _push(mod, server, push, seq):
    """One push of ``push`` into ``server`` with ``mod``'s SparseGrad (a
    server called in process takes its own package's class)."""
    rows, vals, w = push
    server.push({"emb": mod.SparseGrad(rows, vals, nrows=8), "w": w},
                trainer_id=1, seq=seq)


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoints_restore_across_packages_bitwise(tmp_path, direction):
    """A checkpoint of one package's server (sparse rowwise Adam state,
    dedup marks, progress counters) restores into the other's bitwise; a
    replayed push is deduplicated there, and both servers go on bit for
    bit."""
    import paddle_tpu.distributed.param_server as jps
    from paddle_tpu_torch.distributed import param_server as tps

    src_mod, dst_mod = (jps, tps) if direction == "reference_to_port" \
        else (tps, jps)
    path = str(tmp_path / "ps.ckpt")
    rng = np.random.RandomState(5)
    src = src_mod.ParameterServer(optimizer="adam",
                                  opt_kwargs={"lr": 0.01}, mode="async")
    src.init_params({"emb": rng.normal(size=(8, 3)).astype(np.float32),
                     "w": rng.normal(size=(3,)).astype(np.float32)})
    grads = _pushes(rng, 5)
    for s, g in enumerate(grads[:3], start=1):
        _push(src_mod, src, g, s)
    src.save_checkpoint(path)
    dst = dst_mod.ParameterServer(optimizer="adam", opt_kwargs={"lr": 0.01},
                                  mode="async")
    assert dst.restore(path) is True
    for n in ("emb", "w"):
        np.testing.assert_array_equal(dst.pull()[n], src.pull()[n])
        for k, v in src._opt_state[n].items():
            np.testing.assert_array_equal(dst._opt_state[n][k], v)
    assert dst.stats()["applied_seq"] == src.stats()["applied_seq"]
    assert dst.stats()["trainer_steps"] == src.stats()["trainer_steps"]
    before = {n: v.copy() for n, v in dst.pull().items()}
    _push(dst_mod, dst, grads[2], 3)                  # a replay: dedup
    for n, v in before.items():
        np.testing.assert_array_equal(dst.pull()[n], v)
    for s, g in enumerate(grads[3:], start=4):
        _push(src_mod, src, g, s)
        _push(dst_mod, dst, g, s)
    for n in ("emb", "w"):
        np.testing.assert_array_equal(dst.pull()[n], src.pull()[n])
