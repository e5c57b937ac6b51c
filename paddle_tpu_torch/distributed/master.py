"""Elastic data dispatcher — the Go master's task-queue service.

Reference: go/master/service.go — SetDataset builds a task
queue over RecordIO chunks (:280), GetTask leases with per-pass gating
(:368) and timeouts (:341), TaskFinished/TaskFailed with a max-failure
retry limit (:411,455,313), and state snapshots so a restarted master
recovers mid-pass (:166-227, etcd there; a local snapshot file here —
the same recover contract). Trainers are stateless consumers: a dead
trainer's leased chunks time out and are re-dispatched, which is the whole
elastic-training design (doc/v2/design/cluster_train/README.md).

Counterpart of paddle_tpu/distributed/master.py, ported whole: plain
Python, with the same snapshot format, so a snapshot of either package's
master recovers in the other.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
import warnings


class Task:
    __slots__ = ("task_id", "chunks", "failures", "deadline", "epoch")

    def __init__(self, task_id, chunks):
        self.task_id = task_id
        self.chunks = chunks
        self.failures = 0
        self.deadline = None
        self.epoch = 0  # lease epoch: stale finishes/fails are ignored

    def snapshot(self):
        # epoch persists so stale finish/fail calls from pre-crash leases
        # can't collide with fresh post-recovery leases
        return {"task_id": self.task_id, "chunks": self.chunks,
                "failures": self.failures, "epoch": self.epoch}


class Master:
    """Task queue over data chunks with leases, retries and snapshots."""

    def __init__(self, timeout_s=3.0, failure_max=3, snapshot_path=None,
                 snapshot_every=64):
        self._timeout = timeout_s
        self._failure_max = failure_max
        self._snapshot_path = snapshot_path
        # snapshotting rewrites the full queue: amortize it over
        # ``snapshot_every`` state transitions (O(n) per snapshot would be
        # O(n²) per pass if taken on every lease). A snapshot is at most
        # snapshot_every events stale — harmless, since recovery requeues
        # leased tasks anyway (finished-but-unsnapshotted tasks are simply
        # re-done, the at-least-once elastic contract).
        self._snapshot_every = max(1, int(snapshot_every))
        self._events_since_snapshot = 0
        self._lock = threading.Lock()
        self._todo = []       # pending tasks
        self._doing = {}      # task_id -> Task (leased)
        self._done = []
        self._pass_id = 0
        self._next_id = 0
        # cumulative failure events (explicit task_failed + lease
        # expiries), kept as a running counter so backlog() stays O(1)
        # instead of scanning _done for dropped tasks
        self._failures_total = 0
        if snapshot_path:
            # a crash mid-snapshot leaves a stale .tmp beside the real
            # file; it is never valid state (os.replace is the commit
            # point), so clean it up on every start
            try:
                os.unlink(snapshot_path + ".tmp")
            except OSError:
                pass
            if os.path.exists(snapshot_path):
                self._recover()

    # ---- RPC surface ----
    def set_dataset(self, chunks, chunks_per_task=1):
        """Build this pass's queue (reference service.go:280 SetDataset,
        partition :116)."""
        with self._lock:
            self._todo = []
            for i in range(0, len(chunks), chunks_per_task):
                t = Task(self._next_id, list(chunks[i:i + chunks_per_task]))
                self._next_id += 1
                self._todo.append(t)
            self._doing = {}
            self._done = []
            self._pass_id += 1
            self._snapshot_locked(force=True)
            return len(self._todo)

    def get_task(self):
        """Lease the next task; returns None when the pass is complete and
        raises nothing for transient emptiness (reference GetTask :368 —
        all-done vs no-more-available)."""
        with self._lock:
            self._requeue_expired_locked()
            if not self._todo:
                if not self._doing:
                    return None          # pass finished
                return {"wait": True}    # others still leased; retry later
            t = self._todo.pop(0)
            t.deadline = time.monotonic() + self._timeout
            t.epoch += 1
            self._doing[t.task_id] = t
            self._snapshot_locked()
            return {"task_id": t.task_id, "chunks": t.chunks,
                    "epoch": t.epoch}

    def task_finished(self, task_id, epoch):
        """(:411) — stale epochs (a timed-out lease finishing late) are
        ignored so a re-dispatched task isn't double-counted."""
        with self._lock:
            t = self._doing.get(task_id)
            if t is None or t.epoch != epoch:
                return False
            del self._doing[task_id]
            self._done.append(t)
            self._snapshot_locked()
            return True

    def task_failed(self, task_id, epoch):
        """(:455, processFailedTask :313): requeue until failure_max, then
        discard."""
        with self._lock:
            t = self._doing.get(task_id)
            if t is None or t.epoch != epoch:
                return False
            del self._doing[task_id]
            t.failures += 1
            self._failures_total += 1
            if t.failures < self._failure_max:
                self._todo.append(t)
            else:
                self._done.append(t)  # dropped (reference logs + discards)
            self._snapshot_locked()
            return True

    def pass_progress(self):
        with self._lock:
            self._requeue_expired_locked()
            return {"todo": len(self._todo), "doing": len(self._doing),
                    "done": len(self._done), "pass_id": self._pass_id}

    def backlog(self):
        """Cheap queue-depth counts for the trainer autoscaler:
        ``{pending, leased, failed}``. ``failed`` is the CUMULATIVE
        failure-event count (explicit fails + lease expiries), a
        monotone signal rate-rules can watch. O(leased) for the expiry
        sweep, no task/chunk copies — safe to poll on a tight loop."""
        with self._lock:
            self._requeue_expired_locked()
            return {"pending": len(self._todo),
                    "leased": len(self._doing),
                    "failed": self._failures_total}

    def request_save_model(self, trainer_id, block_ms):
        """Save-model arbitration (reference go/master/service.go
        RequestSaveModel): grant exactly one trainer the save slot; other
        requests within ``block_ms`` are rejected — any trainer may save
        (the conventional 0-th trainer can die in elastic training)."""
        with self._lock:
            now = time.monotonic()
            holder, until = getattr(self, "_save_lease", (None, 0.0))
            if until > now and holder != trainer_id:
                return 0
            self._save_lease = (trainer_id, now + block_ms / 1000.0)
            return 1

    # ---- internals ----
    def _requeue_expired_locked(self):
        now = time.monotonic()
        expired = [t for t in self._doing.values()
                   if t.deadline is not None and t.deadline < now]
        for t in expired:
            del self._doing[t.task_id]
            t.failures += 1
            self._failures_total += 1
            if t.failures < self._failure_max:
                self._todo.append(t)
            else:
                self._done.append(t)

    def _snapshot_locked(self, force=False):
        if not self._snapshot_path:
            return
        self._events_since_snapshot += 1
        if not force and self._events_since_snapshot < self._snapshot_every:
            return
        self._events_since_snapshot = 0
        state = {
            "todo": [t.snapshot() for t in self._todo]
            # leased tasks snapshot as pending: a restarted master must
            # re-dispatch them (reference recover :166 requeues doing)
            + [t.snapshot() for t in self._doing.values()],
            "done": [t.snapshot() for t in self._done],
            "next_id": self._next_id,
            "pass_id": self._pass_id,
            "failures_total": self._failures_total,
        }
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, self._snapshot_path)  # atomic

    def _recover(self):
        """Resume from the snapshot; a corrupt/truncated file (the master
        crashed while the disk was unhappy) must NOT crash the restarted
        master — warn and start with a fresh queue instead. The full state
        is parsed before any of it is installed, so a half-bad snapshot
        can't leave a half-recovered queue."""
        try:
            with open(self._snapshot_path, "rb") as f:
                state = pickle.load(f)
            todo, done = [], []
            for s in state["todo"]:
                t = Task(s["task_id"], s["chunks"])
                t.failures = s["failures"]
                t.epoch = s.get("epoch", 0)
                todo.append(t)
            for s in state["done"]:
                t = Task(s["task_id"], s["chunks"])
                t.failures = s["failures"]
                t.epoch = s.get("epoch", 0)
                done.append(t)
            next_id = int(state["next_id"])
            pass_id = int(state["pass_id"])
            failures_total = int(state.get("failures_total", 0))
        except Exception as e:
            warnings.warn(
                f"master snapshot {self._snapshot_path!r} unreadable "
                f"({type(e).__name__}: {e}); starting with a fresh queue")
            return
        self._todo = todo
        self._done = done
        self._next_id = next_id
        self._pass_id = pass_id
        self._failures_total = failures_total


class MasterClient:
    """Trainer-side consumer loop helper (reference python/paddle/v2/master/
    client.py over the Go master's RPC)."""

    def __init__(self, address):
        from .rpc import RpcClient
        self._rpc = RpcClient(address)

    def set_dataset(self, chunks, chunks_per_task=1):
        return self._rpc.call("set_dataset", chunks=list(chunks),
                              chunks_per_task=chunks_per_task)

    def get_task(self):
        """One lease attempt: the raw ``get_task`` RPC result — a task
        dict, ``{"wait": True}`` (everything currently leased), or None
        (pass complete). For stop-aware polling loops that cannot block
        inside :meth:`tasks`."""
        return self._rpc.call("get_task")

    def tasks(self, poll_interval=0.05):
        """Generator yielding (task_id, epoch, chunks); call finished/failed
        per task. Ends when the pass completes."""
        while True:
            t = self._rpc.call("get_task")
            if t is None:
                return
            if t.get("wait"):
                time.sleep(poll_interval)
                continue
            yield t["task_id"], t["epoch"], t["chunks"]

    def finished(self, task_id, epoch):
        return self._rpc.call("task_finished", task_id=task_id, epoch=epoch)

    def failed(self, task_id, epoch):
        return self._rpc.call("task_failed", task_id=task_id, epoch=epoch)

    def progress(self):
        return self._rpc.call("pass_progress")

    def backlog(self):
        """``{pending, leased, failed}`` — the autoscaler's control
        signal (see :meth:`Master.backlog`)."""
        return self._rpc.call("backlog")

    def request_save_model(self, trainer_id, block_ms):
        return self._rpc.call("request_save_model", trainer_id=trainer_id,
                              block_ms=block_ms)

    def close(self):
        self._rpc.close()
