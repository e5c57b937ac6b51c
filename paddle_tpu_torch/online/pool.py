"""TrainerPool: an elastic fleet of StreamingTrainer workers, fed from
the Master task queue and scaled by its backlog (counterpart of
paddle_tpu/online/pool.py).

The trainer-side half of the elastic-training story (the serving half is
the FleetSupervisor): the original Paddle v2 design trains with however
many trainers happen to be alive — trainers lease task chunks from the
Go master, a dead trainer's leases time out and re-dispatch, and the
cluster manager adds or removes trainer pods with traffic. Three pieces
reproduce that here, all over machinery this repo already has:

* :func:`master_task_reader` — the trainer feed path: a reader creator
  whose iterator leases tasks from the :class:`~..distributed.master.
  Master` queue and yields the chunks' feed dicts. ``task_finished``
  fires only when the iterator is asked for the batch AFTER a task's
  last one — with ``prefetch=0`` that is exactly when every batch of
  the task has completed its step (push acked on every shard), so a
  worker crash mid-task never marks the task done: its lease expires
  and the chunks re-dispatch (at-least-once, the Master contract).
* :class:`TrainerPool` — hot-join/retire supervisor over N in-process
  :class:`~.trainer.StreamingTrainer` workers. Each worker gets its own
  ParamClient (unique trainer id), registers a membership lease on
  every pserver shard, and renews it from a per-worker heartbeat thread
  — so a worker blocked at a sync barrier stays a member, while a
  killed worker stops renewing and the shard barriers SHRINK past it at
  lease expiry instead of timing out. A monitor thread reaps crashed
  workers (counted as ``lease_expired``, never as graceful leaves) and
  hot-joins replacements back up to the floor.
* :class:`BacklogAutoscaler` — closes the loop: polls
  ``Master.backlog()``, publishes the pending depth as the
  ``paddle_tpu_online_backlog_tasks`` gauge, judges it with the same
  multi-window :class:`~..obs.slo.SloRule` burn machinery the serving
  SLOs use, and grows the pool one worker per poll while the scale-up
  rule burns (up to ``online_trainers_max``), shrinking back one per
  idle streak once the queue is drained (down to
  ``online_trainers_min``).
"""

from __future__ import annotations

import threading
import time

from ..core.flags import get_flag
from ..obs.metrics import REGISTRY as _METRICS, json_safe, next_instance
from ..obs.recorder import record as _flight_record

_M_JOINS = _METRICS.counter(
    "paddle_tpu_online_trainer_joins",
    "StreamingTrainer workers hot-joined into a TrainerPool (initial "
    "boot, crash replacement, scale-up), per pool instance",
    labels=("instance",))
_M_LEAVES = _METRICS.counter(
    "paddle_tpu_online_trainer_leaves",
    "StreamingTrainer workers retired GRACEFULLY from a TrainerPool "
    "(lease deregistered on every shard), per pool instance",
    labels=("instance",))
_M_LEASE_EXPIRED = _METRICS.counter(
    "paddle_tpu_online_trainer_lease_expired",
    "TrainerPool workers that left WITHOUT deregistering (killed or "
    "crashed — their pserver leases were left to expire and the open "
    "sync barriers shrank past them), per pool instance",
    labels=("instance",))
_M_BACKLOG = _METRICS.gauge(
    "paddle_tpu_online_backlog_tasks",
    "pending (unleased) Master task-queue depth as last polled by the "
    "BacklogAutoscaler — the trainer autoscaler's control signal, per "
    "pool instance", labels=("instance",))


def master_task_reader(address, chunk_feeds, stop=None, follow=True,
                       poll_s=0.1, membership=None):
    """Reader creator leasing task chunks from a Master queue.

    ``address`` is the master RPC endpoint; ``chunk_feeds(chunk)``
    yields the feed dicts one chunk trains on. The returned creator is
    what StreamingTrainer consumes (``prefetch=0`` there — see module
    docstring for why the finish point depends on it). ``stop`` (a
    threading.Event) aborts between batches WITHOUT finishing the
    current task — the crash/retire path; its lease expires and the
    chunks re-dispatch. ``follow=True`` keeps the iterator alive across
    pass boundaries, polling for the next ``set_dataset``; False ends
    the stream when the current pass completes (bounded tests).

    ``membership`` (the worker's ParamClient) ties the pserver
    barrier-membership lease to TASK POSSESSION: register on acquiring
    a task, deregister when going idle. This is the load-bearing rule
    of elastic sync training — a worker polling an empty queue must NOT
    be a barrier member (its peers' rounds would wait the full lease on
    it, or the full barrier timeout if anything kept renewing), while a
    worker mid-task must be one (so killing it shrinks the barrier at
    lease expiry instead of stalling it). Pushes renew the lease while
    the task is being worked, so no heartbeat thread is needed."""
    from ..distributed.master import MasterClient

    def _join():
        if membership is not None:
            try:
                membership.register_trainer()
            except Exception:
                pass     # shard restarting: the push retry re-joins us

    def _leave():
        if membership is not None:
            try:
                membership.deregister_trainer()
            except Exception:
                pass

    def reader():
        mc = MasterClient(tuple(address))
        member = False
        try:
            while stop is None or not stop.is_set():
                t = mc.get_task()
                if t is None or t.get("wait"):
                    # pass complete (None) or all tasks leased: either
                    # way there is nothing to lease right now — leave
                    # the barrier membership so peers don't wait on an
                    # idle worker
                    if member:
                        _leave()
                        member = False
                    if t is None and not follow:
                        return
                    if stop is not None:
                        if stop.wait(poll_s):
                            return
                    else:
                        time.sleep(poll_s)
                    continue
                if not member:
                    _join()
                    member = True
                for chunk in t["chunks"]:
                    for feed in chunk_feeds(chunk):
                        yield feed
                        if stop is not None and stop.is_set():
                            return   # abandoned mid-task: lease expires
                # resumed past the task's last yield: every batch of
                # this task finished its step (push acked) — the one
                # correct instant to mark the lease done
                mc.finished(t["task_id"], t["epoch"])
        finally:
            if member:
                _leave()
            mc.close()

    return reader


class _Worker:
    __slots__ = ("wid", "trainer", "stop_ev", "state")

    def __init__(self, wid, trainer, stop_ev):
        self.wid = wid
        self.trainer = trainer
        self.stop_ev = stop_ev
        self.state = "live"        # live | retiring | crashed


class TrainerPool:
    """Hot-join/retire supervisor over in-process StreamingTrainers.

        pool = TrainerPool(spawn_fn, min_workers=1, max_workers=4)
        pool.start()            # boots min_workers
        pool.add_worker()       # hot-join (scale-up / test chaos)
        pool.kill(wid)          # crash a worker: NO deregister, NO
                                # task_finished — leases expire
        pool.retire_worker(wid) # graceful leave: deregisters everywhere
        pool.stats(); pool.stop()

    ``spawn_fn(worker_id, stop_event)`` returns a STARTABLE (not yet
    started) StreamingTrainer wired with its own ParamClient (unique
    ``trainer_id``) and a reader that honors ``stop_event`` (e.g.
    :func:`master_task_reader`, which also ties the worker's pserver
    barrier-membership lease to task possession — pushes renew it, so
    no heartbeat thread exists to keep a dead worker looking alive).
    The pool supervises: a worker whose thread dies (or is ``kill``ed)
    is counted as ``lease_expired`` and replaced up to ``min_workers``.
    """

    def __init__(self, spawn_fn, min_workers=None, max_workers=None,
                 supervise_s=0.25, stop_timeout_s=30.0):
        if min_workers is None:
            min_workers = int(get_flag("online_trainers_min"))
        if max_workers is None:
            max_workers = int(get_flag("online_trainers_max"))
        if min_workers < 0 or max_workers < max(1, min_workers):
            raise ValueError(
                f"need 0 <= min_workers <= max_workers (and max >= 1), "
                f"got min={min_workers} max={max_workers}")
        self._spawn_fn = spawn_fn
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self._supervise_s = float(supervise_s)
        self._stop_timeout = float(stop_timeout_s)
        self.obs_instance = next_instance("trainer_pool")
        self._m_joins = _M_JOINS.labels(instance=self.obs_instance)
        self._m_leaves = _M_LEAVES.labels(instance=self.obs_instance)
        self._m_lease_expired = _M_LEASE_EXPIRED.labels(
            instance=self.obs_instance)
        self._lock = threading.Lock()
        self._workers = {}            # wid -> _Worker
        # steps banked by departed workers: keeps global_step() (the
        # publish-lineage clock) monotone across churn — a kill must
        # never make the fleet's step counter jump backwards
        self._steps_departed = 0
        self._next_id = 0
        self._stop = threading.Event()
        self._monitor = None
        # incident trigger (IncidentCollector.trigger), fired when the
        # supervisor reaps a crashed worker — same contract as
        # ChildSupervisor.incident_hook
        self.incident_hook = None

    # ------------------------------------------------------------------
    def start(self):
        if self._monitor is not None and self._monitor.is_alive():
            raise RuntimeError("pool already running")
        self._stop.clear()
        for _ in range(self.min_workers):
            self.add_worker()
        self._monitor = threading.Thread(target=self._watch, daemon=True,
                                         name="trainer-pool")
        self._monitor.start()
        return self

    def size(self):
        """Live worker count (crashed-but-unreaped workers excluded)."""
        with self._lock:
            return sum(1 for w in self._workers.values()
                       if w.state == "live" and w.trainer.running())

    def worker_ids(self):
        with self._lock:
            return sorted(w.wid for w in self._workers.values()
                          if w.state == "live")

    # ------------------------------------------------------------------
    def add_worker(self):
        """Hot-join one worker (noop past ``max_workers``); returns the
        worker id, or None when at capacity. The join is visible as a
        ``paddle_tpu_online_trainer_joins`` bump and a ``trainer_join``
        flight event — membership churn must land in incident bundles."""
        with self._lock:
            if self._stop.is_set():
                return None
            live = [w for w in self._workers.values() if w.state == "live"]
            if len(live) >= self.max_workers:
                return None
            wid = self._next_id
            self._next_id += 1
        stop_ev = threading.Event()
        trainer = self._spawn_fn(wid, stop_ev)
        w = _Worker(wid, trainer, stop_ev)
        trainer.start()
        with self._lock:
            self._workers[wid] = w
        self._m_joins.inc()
        _flight_record("trainer_join", component=self.obs_instance,
                       worker=wid, trainer=trainer.obs_instance)
        return wid

    def retire_worker(self, wid, timeout=None):
        """Graceful leave: stop at a step boundary, deregister the
        membership lease on every shard (open barriers shrink NOW, no
        expiry wait), close the client. Returns True when the worker
        existed and stopped."""
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state != "live":
                return False
            w.state = "retiring"
        w.stop_ev.set()
        stopped = w.trainer.stop(self._stop_timeout
                                 if timeout is None else timeout)
        try:
            w.trainer._client.deregister_trainer()
        except Exception:
            pass
        try:
            w.trainer._client.close()
        except Exception:
            pass
        with self._lock:
            self._workers.pop(wid, None)
            self._steps_departed += int(w.trainer.global_step)
        self._m_leaves.inc()
        _flight_record("trainer_leave", component=self.obs_instance,
                       worker=wid, reason="retired",
                       trainer=w.trainer.obs_instance)
        return stopped

    def kill(self, wid):
        """Crash a worker (test/chaos hook — the in-process analog of a
        SIGKILL): the heartbeat and reader stop INSTANTLY, nothing is
        deregistered and no in-flight task is finished — its pserver
        leases expire (shrinking any open barrier) and its Master task
        leases time out and re-dispatch. Counted as ``lease_expired``,
        never as a graceful leave."""
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state != "live":
                return False
            w.state = "crashed"
        w.stop_ev.set()
        # crash fidelity: a SIGKILLed process never deregisters, so the
        # graceful-leave path is neutralized — otherwise the reader's
        # finalizer would politely leave the barrier, and the lease-
        # EXPIRY shrink (the machinery this hook exists to exercise)
        # would never fire
        try:
            w.trainer._client.deregister_trainer = lambda: False
        except Exception:
            pass
        w.trainer.stop(1.0)   # a wedged push thread is abandoned, daemon
        try:
            w.trainer._client.close()
        except Exception:
            pass
        with self._lock:
            self._workers.pop(wid, None)
            self._steps_departed += int(w.trainer.global_step)
        self._m_lease_expired.inc()
        _flight_record("trainer_leave", component=self.obs_instance,
                       worker=wid, reason="killed",
                       trainer=w.trainer.obs_instance)
        if self.incident_hook is not None:
            try:
                self.incident_hook("child_restart",
                                   detail={"supervisor": self.obs_instance,
                                           "worker": wid,
                                           "reason": "killed"})
            except Exception:
                pass
        return True

    # ------------------------------------------------------------------
    def _watch(self):
        """Reap workers whose trainer thread died on its own (reader
        blew up, stop() raced) and hot-join replacements up to the
        floor — the pool's supervision contract."""
        while not self._stop.wait(self._supervise_s):
            dead = []
            with self._lock:
                for w in list(self._workers.values()):
                    if w.state == "live" and not w.trainer.running():
                        w.state = "crashed"
                        dead.append(w)
                        self._workers.pop(w.wid, None)
                        self._steps_departed += int(w.trainer.global_step)
            for w in dead:
                w.stop_ev.set()
                try:
                    w.trainer._client.close()
                except Exception:
                    pass
                self._m_lease_expired.inc()
                _flight_record("trainer_leave",
                               component=self.obs_instance,
                               worker=w.wid, reason="died",
                               trainer=w.trainer.obs_instance)
                if self.incident_hook is not None:
                    try:
                        self.incident_hook(
                            "child_restart",
                            detail={"supervisor": self.obs_instance,
                                    "worker": w.wid, "reason": "died"})
                    except Exception:
                        pass
            # top up to the floor every tick — covers self-died workers
            # reaped above AND explicitly kill()ed ones (already popped)
            while (self.size() < self.min_workers
                   and not self._stop.is_set()):
                if self.add_worker() is None:
                    break

    # ------------------------------------------------------------------
    def scale_to(self, n):
        """Move the live worker count toward ``n`` (clamped to
        [min_workers, max_workers]): hot-join or retire one worker at a
        time. Returns the resulting live count."""
        n = max(self.min_workers, min(self.max_workers, int(n)))
        while self.size() < n:
            if self.add_worker() is None:
                break
        while self.size() > n:
            ids = self.worker_ids()
            if not ids or not self.retire_worker(ids[-1]):
                break
        return self.size()

    def global_step(self):
        """Total steps the fleet has applied: live workers' counters
        plus the banked counts of every departed worker. MONOTONE under
        churn — this is the publish-lineage clock, and a version
        stamped after a kill must never carry a smaller step than one
        stamped before it."""
        with self._lock:
            return self._steps_departed + sum(
                w.trainer.global_step for w in self._workers.values())

    def stats(self):
        with self._lock:
            workers = {w.wid: {"state": w.state,
                               "trainer": w.trainer.stats()}
                       for w in self._workers.values()}
        return json_safe({
            "size": self.size(),
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "joins": int(self._m_joins.value),
            "leaves": int(self._m_leaves.value),
            "lease_expired": int(self._m_lease_expired.value),
            "workers": workers,
        })

    def stop(self):
        """Retire every worker gracefully and stop supervising.
        Idempotent."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(self._supervise_s * 4 + 1.0)
            self._monitor = None
        for wid in list(self._workers):
            with self._lock:
                w = self._workers.get(wid)
                if w is None:
                    continue
                w.state = "retiring"
            w.stop_ev.set()
            w.trainer.stop(self._stop_timeout)
            try:
                w.trainer._client.deregister_trainer()
            except Exception:
                pass
            try:
                w.trainer._client.close()
            except Exception:
                pass
            with self._lock:
                self._workers.pop(wid, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class BacklogAutoscaler:
    """Scale a TrainerPool from the Master's backlog via SloRules.

    ``backlog_fn()`` returns ``{pending, leased, failed}`` (the
    Master/MasterClient ``backlog()`` surface). Every poll publishes
    the pending depth to the ``paddle_tpu_online_backlog_tasks`` gauge,
    evaluates the scale-up rules with the standard multi-window burn
    machinery (:class:`~..obs.slo.SloMonitor`), and then:

    * any rule breached -> hot-join ONE worker (up to the pool max);
    * queue fully drained (pending == leased == 0) for ``idle_polls``
      consecutive polls -> retire ONE worker (down to the pool min).

    One step per poll keeps scaling smooth — the burn windows already
    damp flapping. Default rule: pending depth measured against an
    objective of one task per pool-max worker over a short window."""

    def __init__(self, pool, backlog_fn, rules=None, poll_s=None,
                 idle_polls=3, on_breach=None):
        from ..obs.slo import SloMonitor, SloRule

        self.pool = pool
        self._backlog_fn = backlog_fn
        self._poll_s = float(get_flag("obs_slo_interval_s")
                             if poll_s is None else poll_s)
        self._idle_polls = int(idle_polls)
        if rules is None:
            rules = [SloRule(
                "online_trainer_backlog",
                metric="paddle_tpu_online_backlog_tasks",
                objective=float(max(1, pool.max_workers)),
                reducer="value",
                labels={"instance": pool.obs_instance},
                windows=((max(2.0 * self._poll_s, 1.0), 1.0),),
                description="pending Master tasks per max-pool worker; "
                            "burning means ingest is outrunning the "
                            "current trainer fleet")]
        self._monitor = SloMonitor(rules, interval_s=self._poll_s,
                                   on_breach=on_breach)
        self._m_backlog = _M_BACKLOG.labels(instance=pool.obs_instance)
        self._idle_streak = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._last_backlog = None
        self._last_error = None
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------------
    def poll_once(self):
        """One control-loop pass (also the test entry): measure, judge,
        maybe scale one step. Returns the per-rule status."""
        b = self._backlog_fn()
        self._last_backlog = dict(b)
        self._m_backlog.set(float(b["pending"]))
        status = self._monitor.evaluate_once()
        burning = any(not s["ok"] for s in status.values())
        if burning:
            self._idle_streak = 0
            if self.pool.size() < self.pool.max_workers:
                if self.pool.add_worker() is not None:
                    self._scale_ups += 1
        elif b["pending"] == 0 and b["leased"] == 0:
            self._idle_streak += 1
            if self._idle_streak >= self._idle_polls:
                self._idle_streak = 0
                if self.pool.size() > self.pool.min_workers:
                    ids = self.pool.worker_ids()
                    if ids and self.pool.retire_worker(ids[-1]):
                        self._scale_downs += 1
        else:
            self._idle_streak = 0
        return status

    def _watch(self):
        while not self._stop.wait(self._poll_s):
            try:
                self.poll_once()
            except Exception as e:   # the control loop must never die
                self._last_error = f"{type(e).__name__}: {e}"

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("autoscaler already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="trainer-autoscaler")
        self._thread.start()
        return self

    def stop(self, timeout=10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        return True

    def stats(self):
        return json_safe({
            "poll_s": self._poll_s,
            "backlog": self._last_backlog,
            "scale_ups": self._scale_ups,
            "scale_downs": self._scale_downs,
            "idle_streak": self._idle_streak,
            "pool_size": self.pool.size(),
            "rules": self._monitor.status(),
            "last_error": self._last_error,
        })


__all__ = ["TrainerPool", "BacklogAutoscaler", "master_task_reader"]
