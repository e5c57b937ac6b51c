"""A pool of N ranks of one ``torch.distributed`` process group on this
host, each a fresh interpreter that imports nothing of the JAX package:
``RankPool(nproc)`` keeps the ranks up and runs several calls on them
(``pool.run(target, *args)`` returns every rank's result); the process
group is made once, so a test file pays the start-up once. Starting N
copies of a script as the ranks is ``distributed.launch.launch``.

``target`` is a module-level function (pickled by reference). Every wait
is bounded: a rank that does not answer in time, or that raised while its
peers wait on it in a collective, makes the call fail and the ranks are
killed. Each rank runs with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set (``env``
may set the local pair, to lay the ranks out as several hosts), so
``multihost.init_multihost()`` reads them as ``env://``; the pool's ranks
join the group before their first call. Backend "nccl" gives rank r the
card r; "gloo" runs on the CPU with one intra-op thread a rank.
"""

from __future__ import annotations

import os
import pickle
import secrets
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Client, Listener

from ..distributed.launch import free_port

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# seconds a rank has to start and join the group, and the pool to stop
_START_TIMEOUT = 120.0
_STOP_TIMEOUT = 30.0

_BOOT = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from paddle_tpu_torch.parallel.launch import _rank_main; "
         "_rank_main()")


def _rank_main():
    """A rank: connect to the parent, join the group, serve calls."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    ctl_port, key, backend, timeout = sys.argv[2:6]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    conn = Client(("127.0.0.1", int(ctl_port)), authkey=bytes.fromhex(key))
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank,
                            timeout=timedelta(seconds=float(timeout)))
    conn.send(("ready", rank))
    reply = ("ok", None)
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            fn, args, kwargs = pickle.loads(msg[1])
            try:
                reply = ("ok", fn(*args, **kwargs))
            except BaseException:
                reply = ("err", traceback.format_exc())
            conn.send(reply)
    finally:
        dist.destroy_process_group()
        conn.close()
    sys.exit(0 if reply[0] == "ok" else 1)


class RankError(RuntimeError):
    """A rank raised, hung or died; the message holds what each said."""


class RankPool:
    """``nproc`` ranks of one process group, started together: each has
    ``_START_TIMEOUT`` seconds to start and join the group, and each call
    ``timeout`` seconds (also the group's collective timeout)."""

    def __init__(self, nproc, backend="gloo", timeout=120.0, env=None):
        self.nproc = nproc
        self.timeout = float(timeout)
        key = secrets.token_bytes(16)
        self._listener = Listener(("127.0.0.1", 0), authkey=key)
        ctl_port = self._listener.address[1]
        master = str(free_port())
        self.procs = []
        for rank in range(nproc):
            e = dict(os.environ)
            e.setdefault("TORCH_CPP_LOG_LEVEL", "ERROR")
            e.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nproc))
            e.update(env or {})
            e.update(RANK=str(rank), WORLD_SIZE=str(nproc),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=master)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _BOOT, _ROOT, str(ctl_port),
                 key.hex(), backend, str(max(self.timeout, _START_TIMEOUT))],
                env=e))
        self.conns = [None] * nproc
        accepted = []

        def accept():
            for _ in range(nproc):
                accepted.append(self._listener.accept())

        t = threading.Thread(target=accept, daemon=True)
        t.start()
        t.join(_START_TIMEOUT)
        if len(accepted) < nproc:
            self.kill()
            raise RankError(f"{nproc - len(accepted)} of {nproc} ranks did "
                            f"not start in {_START_TIMEOUT:.0f} s")
        ready = self._gather(accepted, _START_TIMEOUT, "join the group")
        for conn, (_, rank) in zip(accepted, ready):
            self.conns[rank] = conn

    def _gather(self, conns, timeout, what):
        deadline = time.monotonic() + timeout
        out, errors = [None] * len(conns), []
        for i, conn in enumerate(conns):
            left = max(0.0, deadline - time.monotonic())
            try:
                if not conn.poll(left):
                    errors.append(f"rank {i}: no answer in {timeout:.0f} s "
                                  f"({what})")
                    continue
                out[i] = conn.recv()
            except (EOFError, OSError):
                code = self.procs[i].poll()
                errors.append(f"rank {i}: died (exit code {code})")
                continue
            if out[i][0] == "err":
                errors.append(f"rank {i} raised:\n{out[i][1]}")
        if errors:
            self.kill()
            raise RankError("\n".join(errors))
        return out

    def run(self, target, *args, **kwargs):
        """``target(*args, **kwargs)`` on every rank; the ranks' results in
        rank order."""
        if any(p.poll() is not None for p in self.procs):
            raise RankError("the pool has a rank that is no longer running")
        blob = pickle.dumps((target, args, kwargs))
        for conn in self.conns:
            conn.send(("call", blob))
        replies = self._gather(self.conns, self.timeout,
                               getattr(target, "__name__", str(target)))
        return [r[1] for r in replies]

    def close(self):
        """Stop the ranks; their exit codes (-9 where killed)."""
        for conn in self.conns:
            try:
                conn.send(("stop", None))
            except (OSError, AttributeError):
                pass
        return self._join(_STOP_TIMEOUT)

    def _join(self, timeout):
        deadline = time.monotonic() + timeout
        codes = []
        for p in self.procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            codes.append(p.returncode)
        self._listener.close()
        return codes

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        self._listener.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:
            self.kill()
        return False

