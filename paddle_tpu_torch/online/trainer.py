"""StreamingTrainer: train forever on an unbounded reader, publish on a
cadence, survive pserver restarts (counterpart of
paddle_tpu/online/trainer.py).

The trainer half of the original Paddle v2 online-learning story (the Go
pserver cluster that trains on an unbounded stream while the same model
serves): one thread looping pull -> forward/backward -> push against the
transpiled trainer program, with the optimizer living server-side. Three
properties matter beyond the plain loop in ``test_fluid_trainer``:

* **unbounded input** — the reader never ends; ``prefetch`` wraps it in
  ``reader.prefetch.background_buffer`` (the reader/pool.py staging
  machinery) so host-side batch prep overlaps the device step.
* **publish triggers that don't stall the hot path** — every
  ``online_publish_every_steps`` steps (and/or ``online_publish_every_s``
  seconds), checked AT A STEP BOUNDARY: the push has acked on every
  shard, no update is in flight, so ``CheckpointFreezer.request_freeze``
  can take a barrier-consistent cut with one cheap prepare RPC per
  shard; the heavy stitch/publish runs on the freezer's worker. A failed
  or skipped freeze does NOT reset the cadence — the trainer retries at
  the next boundary.
* **crash tolerance, in two phases** — a failed pull/forward/backward
  (pserver shard restarting; the ParamClient's RetryPolicy exhausted)
  is COUNTED and its batch dropped, not fatal: nothing remote was
  mutated yet, online learning tolerates a lost batch, and a dead
  training loop loses the whole stream. A failed PUSH is different:
  some shard may already have applied it (advancing its sync round),
  so the push retries WITH THE SAME SEQUENCE NUMBER until every shard
  acks — applied shards answer from the dedup table, the restarted
  shard applies, and the rounds stay in lockstep (dropping a partially
  applied push would desynchronize the rounds forever and every later
  freeze cut would be rejected as torn). A reader failure ends the
  stream but lands loudly in ``stats()`` (``reader_failed`` +
  ``last_error``), never as a silently dead thread.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..core.flags import get_flag
from ..distributed.param_server import install_params
from ..obs.metrics import (REGISTRY as _METRICS, json_safe,
                           next_instance)
from ..obs.recorder import record as _flight_record

_M_STEPS = _METRICS.counter(
    "paddle_tpu_online_trainer_steps",
    "global steps completed by a StreamingTrainer (push acked on every "
    "shard), per instance", labels=("instance",))
_M_STEP_FAILURES = _METRICS.counter(
    "paddle_tpu_online_trainer_step_failures",
    "dropped batches (pull/run failures; push retries are separate), "
    "per instance", labels=("instance",))
_M_PUSH_RETRIES = _METRICS.counter(
    "paddle_tpu_online_trainer_push_retries",
    "same-seq push retries riding out shard restarts, per instance",
    labels=("instance",))
_M_STEP_SECONDS = _METRICS.histogram(
    "paddle_tpu_online_train_step_seconds",
    "StreamingTrainer full-step latency window, per instance",
    labels=("instance",), span_name="online/train_step",
    span_kind="online")


class _Stopped(Exception):
    """Internal: the trainer was stopped while retrying a push."""


class StreamingTrainer:
    """Continuous trainer over a transpiled program.

        t = fluid.DistributeTranspiler()
        t.transpile(0, program=main, pservers=..., trainers=1)
        client = t.trainer_client(retry=RetryPolicy(), endpoints=sup.addresses)
        trainer = StreamingTrainer(exe, scope, t.get_trainer_program(),
                                   t.params_grads, client, reader,
                                   freezer=freezer)
        trainer.start()
        ... trainer.stats() ...
        trainer.stop()

    ``reader`` is a paddle-style creator: a callable returning an
    iterator of FEED DICTS (name -> batch ndarray). ``params_grads`` is
    the transpiler's ``[(param, grad)]`` list — the grads are fetched
    each step and pushed under their param names. ``extra_fetch`` names
    (e.g. the loss) are fetched alongside and surfaced through
    ``stats()["last_extra"]``. The pulled parameters are copied into
    the scope's tensors on the executor's device each step
    (``install_params``).
    """

    def __init__(self, executor, scope, program, params_grads, client,
                 reader, freezer=None, publish_every_steps=None,
                 publish_every_s=None, extra_fetch=(), prefetch=2):
        self._exe = executor
        self._scope = scope
        self._program = program
        self._pg = [(p, g) for p, g in params_grads]
        self._client = client
        self._reader = reader
        self._freezer = freezer
        if publish_every_steps is None:
            publish_every_steps = int(get_flag("online_publish_every_steps"))
        if publish_every_s is None:
            publish_every_s = float(get_flag("online_publish_every_s"))
        self._pub_steps = int(publish_every_steps)
        self._pub_s = float(publish_every_s)
        self._extra = [e if isinstance(e, str) else e.name
                       for e in extra_fetch]
        self._fetch = [g for _p, g in self._pg] + self._extra
        self._prefetch = int(prefetch)
        self._step = 0
        self._reader_failed = False
        self._publish_requests = 0
        self._publish_accepted = 0
        self._pending_job = None     # last ACCEPTED cut, until resolved
        self._last_error = None
        self._last_extra = {}
        # step/failure/retry counters + step latency live in the
        # obs.metrics registry under this trainer's instance label
        # (stats() derives from them; _step stays local — it is loop
        # control state, mirrored into the counter at each boundary)
        self.obs_instance = next_instance("trainer")
        self._m_steps = _M_STEPS.labels(instance=self.obs_instance)
        self._m_step_failures = _M_STEP_FAILURES.labels(
            instance=self.obs_instance)
        self._m_push_retries = _M_PUSH_RETRIES.labels(
            instance=self.obs_instance)
        self.step_latency = _M_STEP_SECONDS.labels(
            instance=self.obs_instance)
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------------
    @property
    def global_step(self):
        return self._step

    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        if self.running():
            raise RuntimeError("trainer already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="streaming-trainer")
        self._thread.start()
        return self

    def stop(self, timeout=30.0):
        """Stop at the next step boundary; returns True once joined."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    # ------------------------------------------------------------------
    def _push_with_retry(self, grads):
        """Push until every shard acks, re-sending the SAME sequence
        number across attempts (see ``ParamClient.allocate_seq``): a
        sync-mode trainer cannot make progress past a dead shard anyway,
        and retrying is the only path that keeps the shards' rounds
        consistent. Gives up only when the trainer is stopped."""
        seq = self._client.allocate_seq()
        while True:
            try:
                return self._client.push(grads, seq=seq)
            except Exception as e:
                self._m_push_retries.inc()
                # the retry DECISION: a partially-applied push is being
                # re-sent with the SAME seq through a shard restart —
                # exactly what an incident bundle needs to explain a
                # training stall
                _flight_record("push_retry", component=self.obs_instance,
                               seq=seq, error=type(e).__name__)
                self._last_error = f"push(seq={seq}): " \
                                   f"{type(e).__name__}: {e}"
                if self._stop.wait(0.25):
                    raise _Stopped from e

    def _publish_due(self, steps_since, last_t):
        if self._freezer is None:
            return False
        if self._pending_job is not None and self._pending_job.done():
            failed = self._pending_job.failed()
            self._pending_job = None
            if failed:
                # the ACCEPTED cut died in its async stitch (a shard
                # restarted between prepare and fetch, a publish error):
                # the publish it stood for never happened, so it is due
                # NOW, not a full cadence later — the cadence reset at
                # acceptance was provisional
                return True
        if self._pub_steps > 0 and steps_since >= self._pub_steps:
            return True
        if self._pub_s > 0 and time.monotonic() - last_t >= self._pub_s:
            return True
        return False

    def _run(self):
        reader = self._reader
        if self._prefetch > 0:
            from ..reader.prefetch import background_buffer
            reader = background_buffer(reader, self._prefetch)
        steps_since_pub = 0
        last_pub_t = time.monotonic()
        it = iter(reader())
        while not self._stop.is_set():
            try:
                feed = next(it)
            except StopIteration:
                break                      # bounded reader (tests) drained
            except Exception as e:
                # a broken data source is not recoverable from here, but
                # it must be LOUD in stats, not a silently dead thread
                self._last_error = f"reader: {type(e).__name__}: {e}"
                self._reader_failed = True
                break
            try:
                # phase 1 — pull + forward/backward: nothing remote
                # mutated yet, so a failure here safely DROPS the batch
                with self.step_latency.span():
                    install_params(self._scope, self._client.pull(),
                                   device=self._exe.device)
                    fetched = self._exe.run(self._program, feed=feed,
                                            fetch_list=self._fetch,
                                            scope=self._scope)
                    # SparseRows grads (is_sparse embeddings) ship as-is
                    # on the O(touched-rows) wire; dense grads as host
                    # ndarrays
                    grads = {p: f if hasattr(f, "rows") else np.asarray(f)
                             for (p, _g), f in zip(self._pg, fetched)}
                    # phase 2 — push: once sent, SOME shard may have
                    # applied it (advancing its sync round), so a failed
                    # push is RETRIED WITH THE SAME SEQ until every shard
                    # acks — shards that applied answer from the dedup
                    # table, the restarted one applies, and the rounds
                    # stay in lockstep. Dropping a partially-applied push
                    # would desynchronize the rounds FOREVER and every
                    # later freeze cut would be rejected as torn.
                    self._push_with_retry(grads)
                if self._extra:
                    base = len(self._pg)
                    self._last_extra = {
                        n: np.asarray(fetched[base + i]).tolist()
                        for i, n in enumerate(self._extra)}
                self._step += 1
                self._m_steps.inc()
                steps_since_pub += 1
            except _Stopped:
                break
            except Exception as e:
                # pull/run failure (restarting shard): count, drop the
                # batch, back off a beat, continue
                self._m_step_failures.inc()
                self._last_error = f"{type(e).__name__}: {e}"
                if self._stop.wait(0.05):
                    break
                continue
            # the step BOUNDARY: push acked on every shard, nothing in
            # flight — the one instant a barrier-consistent cut is free
            if self._publish_due(steps_since_pub, last_pub_t):
                self._publish_requests += 1
                try:
                    job = self._freezer.request_freeze(self._step)
                except RuntimeError as e:
                    # freezer closed out from under a still-running
                    # trainer: keep training, stop triggering
                    self._last_error = f"{type(e).__name__}: {e}"
                    self._freezer = None
                    continue
                if job is not None:
                    self._publish_accepted += 1
                    self._pending_job = job
                    steps_since_pub = 0
                    last_pub_t = time.monotonic()
                # else: cut failed / stitcher busy — cadence NOT reset,
                # the next boundary retries (freezer.stats has details)

    # ------------------------------------------------------------------
    def stats(self):
        return json_safe(
            {"global_step": self._step,
             "running": self.running(),
             "step_failures": int(self._m_step_failures.value),
             "push_retries": int(self._m_push_retries.value),
             "reader_failed": self._reader_failed,
             "publish_requests": self._publish_requests,
             "publish_accepted": self._publish_accepted,
             "last_error": self._last_error,
             "last_extra": dict(self._last_extra),
             "step_latency": self.step_latency.snapshot()})


__all__ = ["StreamingTrainer"]
