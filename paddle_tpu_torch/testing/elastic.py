"""Trainer processes for the parameter-server and elastic-master tests,
started with ``distributed.launch.spawn_child`` (a fresh interpreter that
imports numpy and ``distributed/``, not torch). Each is a module-level
function of plain arguments; a worker writes what it did to ``out_path``
as JSON, which the test reads after joining it.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def torch_loaded(out_path):
    """Write whether this process has imported torch."""
    with open(out_path, "w") as f:
        json.dump({"torch": "torch" in sys.modules}, f)


def victim_trainer(address, hold_s):
    """Lease one task from the master, then hang (to be killed)."""
    from ..distributed import MasterClient
    c = MasterClient(tuple(address))
    c.get_task()
    time.sleep(hold_s)


def elastic_w_true():
    return np.random.RandomState(0).normal(0, 1, (8,)).astype(np.float32)


def elastic_chunk_xy(name):
    rng = np.random.RandomState(1000 + int(name[1:]))
    X = rng.normal(0, 1, (32, 8)).astype(np.float32)
    return X, X @ elastic_w_true()


def _wait_for_file(path, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.005)


def elastic_sync_worker(master_addr, ps_addrs, tid, out_path,
                        start_after=None, gate=None):
    """Lease tasks from the Master, hold a pserver membership lease ONLY
    while working a task, train with same-seq retried pushes, write the
    processed chunks to ``out_path``, deregister on the way out. With
    ``start_after`` it starts once that file exists (a hot join at a
    moment the test picks, not when the interpreter is up); with ``gate``
    it waits for that file after its first registration (so the first
    members all register before any of them pushes)."""
    from ..distributed import MasterClient, ParamClient
    if start_after:
        _wait_for_file(start_after)
    mc = MasterClient(tuple(master_addr))
    pc = ParamClient([tuple(a) for a in ps_addrs], trainer_id=tid,
                     param_names=["a", "b"])
    processed = []
    member = False
    while True:
        t = mc.get_task()
        if t is None:
            break
        if t.get("wait"):
            if member:
                pc.deregister_trainer()
                member = False
            time.sleep(0.05)
            continue
        if not member:
            pc.register_trainer()
            member = True
            if gate:
                _wait_for_file(gate)
                gate = None
        for name in t["chunks"]:
            X, y = elastic_chunk_xy(name)
            for _ in range(4):
                p = pc.pull()
                w = np.concatenate([p["a"], p["b"]])
                g = ((2.0 / len(X)) * (X.T @ (X @ w - y))) \
                    .astype(np.float32)
                seq = pc.allocate_seq()
                while True:   # same-seq retry: the round-lockstep rule
                    try:
                        pc.push({"a": g[:4], "b": g[4:]}, seq=seq)
                        break
                    except Exception:
                        time.sleep(0.05)
        mc.finished(t["task_id"], t["epoch"])
        processed.extend(t["chunks"])
    if member:
        pc.deregister_trainer()
    with open(out_path, "w") as f:
        json.dump({"tid": tid, "processed": processed}, f)
    pc.close()
    mc.close()


def elastic_sync_victim(master_addr, ps_addrs, tid, gate=None):
    """Lease one Master task (never finished), join the barrier
    membership, wait for ``gate`` (as elastic_sync_worker), and push zero
    gradients on a tight loop until killed."""
    from ..distributed import MasterClient, ParamClient
    mc = MasterClient(tuple(master_addr))
    pc = ParamClient([tuple(a) for a in ps_addrs], trainer_id=tid,
                     param_names=["a", "b"])
    while True:                    # hold a task lease to the grave
        t = mc.get_task()
        if t and not t.get("wait"):
            break
        time.sleep(0.01)
    pc.register_trainer()
    if gate:
        _wait_for_file(gate)
    z = np.zeros(4, np.float32)
    while True:
        try:
            pc.push({"a": z, "b": z}, seq=pc.allocate_seq())
        except Exception:
            time.sleep(0.02)


def echo_child(address, token):
    """A supervised child that answers ``stats`` with its token and pid
    (the child-supervisor restart tests)."""
    from ..distributed.rpc import RpcServer

    class _Echo:
        def stats(self):
            return {"token": token, "pid": os.getpid()}

    RpcServer(_Echo(), tuple(address)).serve_forever()
