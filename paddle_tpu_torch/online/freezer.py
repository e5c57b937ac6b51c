"""CheckpointFreezer: barrier-consistent pserver cuts stitched into
published inference bundles (counterpart of paddle_tpu/online/freezer.py).

The freeze is the hinge of the online-learning loop: the parameters live
sharded across pserver processes that apply updates continuously, and a
published model must be a CONSISTENT cut — every shard at the same sync
round, never a torn mix where shard 0 has step S's gradient and shard 1
does not (two halves of one embedding trained to different instants).

The cut protocol splits cheap from heavy:

1. **prepare** (``ParamClient.snapshot_prepare``) — called from the
   trainer's thread AT A STEP BOUNDARY, i.e. after ``push`` acked on
   every shard and before the next one is sent, so no update is in
   flight. Each shard copies its params under its apply lock (one
   memcpy) and reports its sync round; the freezer verifies all rounds
   agree and otherwise releases the tag and reports a torn cut. This is
   the only work on the training hot path: one small concurrent RPC per
   shard.
2. **stitch** (worker thread, off the hot path) — fetch the frozen
   copies (the heavy transfer), overlay them on a template scope holding
   the non-pserver persistables, prune + export through
   ``save_inference_model``, and ``ModelRegistry.publish`` with lineage
   metadata (``global_step``, ``parent_version``, ``freeze_round``).

Because the frozen copies are immutable server-side, training continues
at full speed while the stitcher pulls and publishes; a freeze requested
while the stitcher is busy is SKIPPED (tag released, counter bumped) and
the trainer simply retries at a later boundary — publishes are periodic,
not queued, so there is nothing to backlog.

Bitwise contract: the published ``.npy`` params are byte-identical to
the shard state at the prepare instant (tests pin this against a pserver
checkpoint taken at the same sync round, dense and sparse rowwise-
optimizer params alike).
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
import time

import numpy as np

from ..obs.metrics import (REGISTRY as _METRICS, json_safe,
                           next_instance)

# freeze outcomes in the obs.metrics registry: published / skipped_busy /
# failed_<phase> (prepare, torn, stitch) — stats() derives its historical
# counters dict from these children
_M_FREEZES = _METRICS.counter(
    "paddle_tpu_online_freezes",
    "CheckpointFreezer cut outcomes (published, skipped_busy, "
    "failed_prepare, failed_torn, failed_stitch), per instance",
    labels=("instance", "outcome"))
_M_FREEZE_SECONDS = _METRICS.histogram(
    "paddle_tpu_online_freeze_seconds",
    "freeze stitch+publish latency window, per instance",
    labels=("instance",), span_name="online/freeze", span_kind="online")


def _host_copy(v):
    """A host numpy copy of a scope value (a tensor on any device)."""
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().copy()
    return np.array(v)


class FreezeError(RuntimeError):
    """A freeze attempt failed (torn cut, unreachable shard, stitch or
    publish error). The loop treats these as retryable: the next trigger
    cuts fresh."""


class _Job:
    """One accepted cut awaiting its stitch; ``wait`` resolves to the
    published version (or raises the stitch error)."""

    def __init__(self, tag, round_, step):
        self.tag = tag
        self.round = round_
        self.step = step
        self.version = None
        self.error = None
        self._done = threading.Event()

    def resolve(self, version=None, error=None):
        self.version = version
        self.error = error
        self._done.set()

    def done(self):
        return self._done.is_set()

    def failed(self):
        """Resolved with a stitch/publish error — the accepted cut never
        became a version (the trainer's cadence treats this as 'publish
        still owed': retry at the next step boundary)."""
        return self._done.is_set() and self.error is not None

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"freeze (step {self.step}, round {self.round}) did not "
                f"publish within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.version


class CheckpointFreezer:
    """Freeze pserver state into registry versions.

        freezer = CheckpointFreezer(client, registry, "ranker",
                                    main_program, ["x"], ["softmax_out"],
                                    template_scope=scope)
        v1 = freezer.request_freeze(0, wait=True)     # initial publish
        ...                                           # from the trainer:
        freezer.request_freeze(step)                  # cut now, stitch async

    ``inference_program`` is the model's program (optimizer ops included
    are fine — ``save_inference_model`` prunes to the fetch path);
    ``template_scope`` supplies persistables the pservers do NOT hold
    (copied once at construction, so later trainer mutation never leaks
    into a freeze); pserver-held params always come from the cut.
    ``executor`` (default: one on ``place``, the card unless the caller
    asks for the CPU) is the export's.
    """

    def __init__(self, client, registry, model, inference_program,
                 feed_names, target_names, executor=None,
                 template_scope=None, place=None):
        self._client = client
        self._registry = registry
        self._model = model
        self._program = inference_program
        self._feed_names = list(feed_names)
        self._target_names = [t if isinstance(t, str) else t.name
                              for t in target_names]
        if executor is None:
            from ..core.executor import Executor
            executor = Executor(place)
        self._exe = executor
        # non-pserver persistables (e.g. stats a trainer updates in-graph)
        # frozen ONCE: a freeze must not read a scope another thread is
        # mutating. Pserver params overwrite these per cut.
        self._template = {}
        if template_scope is not None:
            for block in inference_program.blocks:
                for name, var in block.vars.items():
                    if getattr(var, "persistable", False):
                        v = template_scope.find_var(name)
                        if v is not None:
                            self._template[name] = _host_copy(v)
        self._cut_lock = threading.Lock()
        self._cut_seq = 0
        self._jobs = queue.Queue(maxsize=1)
        self._stats_lock = threading.Lock()
        self._last_error = None
        self._last_publish = None    # {"version", "step", "round", "at"}
        # outcome counters + stitch latency in the obs.metrics registry
        self.obs_instance = next_instance("freezer")
        self._m_outcome = {}         # outcome -> counter child (lazy)
        self.latency = _M_FREEZE_SECONDS.labels(instance=self.obs_instance)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name="checkpoint-freezer")
        self._worker.start()

    # ------------------------------------------------------------------
    def _count(self, outcome):
        child = self._m_outcome.get(outcome)
        if child is None:
            child = self._m_outcome[outcome] = _M_FREEZES.labels(
                instance=self.obs_instance, outcome=outcome)
        child.inc()

    def _outcome_value(self, outcome):
        child = self._m_outcome.get(outcome)
        return int(child.value) if child is not None else 0

    def _record_failure(self, phase, err):
        self._count(f"failed_{phase}")
        with self._stats_lock:
            self._last_error = f"{phase}: {type(err).__name__}: {err}"

    def request_freeze(self, global_step, wait=False, timeout=None):
        """Cut NOW (cheap, call at a step boundary) and hand the stitch
        to the worker. Returns the accepted :class:`_Job`, or with
        ``wait=True`` blocks for the published version (raising
        :class:`FreezeError` when the cut or the stitch failed — a
        waiting caller, like the loop's mandatory v1 publish, must never
        get a silent None). Without ``wait``, a failed cut or a busy
        stitcher returns None — the trainer retries at a later boundary;
        details land in :meth:`stats`."""
        if self._stop.is_set():
            raise RuntimeError("freezer is closed")
        with self._cut_lock:
            self._cut_seq += 1
            tag = f"freeze-{os.getpid()}-{self._cut_seq}"
            err = None
            try:
                rounds = self._client.snapshot_prepare(tag)
            except Exception as e:
                self._record_failure("prepare", e)
                # prepare may have landed on SOME shards before the
                # failing one; drop those copies
                self._client.snapshot_release(tag)
                err = FreezeError(f"freeze cut failed at prepare: "
                                  f"{type(e).__name__}: {e}")
                err.__cause__ = e
            if err is None:
                distinct = set(rounds.values())
                if len(distinct) > 1:
                    self._client.snapshot_release(tag)
                    err = FreezeError(
                        f"torn cut: shard rounds disagree {rounds} — "
                        "cut must happen at a step boundary")
                    self._record_failure("torn", err)
            if err is None:
                job = _Job(tag, distinct.pop(), int(global_step))
                try:
                    self._jobs.put_nowait(job)
                except queue.Full:
                    self._client.snapshot_release(tag)
                    self._count("skipped_busy")
                    err = FreezeError("freeze skipped: a previous cut is "
                                      "still stitching")
        if err is not None:
            if wait:
                raise err
            return None
        if wait:
            return job.wait(timeout)
        return job

    # ------------------------------------------------------------------
    def _drain(self):
        while True:
            try:
                # bounded get: when close() could not land its sentinel
                # (a job already occupied the one-slot queue), the worker
                # still notices _stop once the backlog drains
                job = self._jobs.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if job is None:
                return
            try:
                with self.latency.span():
                    version = self._stitch(job)
                self._count("published")
                with self._stats_lock:
                    self._last_publish = {"version": version,
                                          "step": job.step,
                                          "round": job.round,
                                          "at": time.time()}
                job.resolve(version=version)
            except Exception as e:
                self._record_failure("stitch", e)
                self._client.snapshot_release(job.tag)
                job.resolve(error=FreezeError(
                    f"freeze at step {job.step} failed: "
                    f"{type(e).__name__}: {e}"))

    def _stitch(self, job):
        """Heavy half: fetch the frozen cut, overlay on the template,
        export, publish. Runs on the worker thread only."""
        from ..core.scope import Scope
        from ..fluid.io import save_inference_model

        params, rounds = self._client.snapshot_fetch(job.tag)
        self._client.snapshot_release(job.tag)
        if set(rounds.values()) != {job.round}:
            # a shard restarted between prepare and fetch and re-served
            # the tag (impossible today — restart loses tags — but the
            # invariant is cheap to keep explicit)
            raise FreezeError(
                f"fetched rounds {rounds} do not match the prepared "
                f"round {job.round}")
        scope = Scope()
        for name, value in self._template.items():
            scope.set(name, value)
        for name, value in params.items():
            scope.set(name, value)
        tmp = tempfile.mkdtemp(prefix="pdtpu-freeze-")
        try:
            save_inference_model(tmp, self._feed_names, self._target_names,
                                 self._exe, self._program, scope=scope)
            published = self._registry.versions(self._model)
            parent = published[-1] if published else None
            return self._registry.publish(
                self._model, tmp,
                lineage={"global_step": job.step,
                         "freeze_round": job.round,
                         "parent_version": parent})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------------------------
    def stats(self):
        # the historical shape, derived from the registry outcome
        # children (failures keyed by phase, zero-count phases omitted)
        failures = {}
        for outcome in list(self._m_outcome):
            if outcome.startswith("failed_"):
                n = self._outcome_value(outcome)
                if n:
                    failures[outcome[len("failed_"):]] = n
        with self._stats_lock:
            last_error = self._last_error
            last_publish = dict(self._last_publish) \
                if self._last_publish else None
        return json_safe({"published": self._outcome_value("published"),
                          "skipped_busy": self._outcome_value(
                              "skipped_busy"),
                          "failures": failures,
                          "last_error": last_error,
                          "last_publish": last_publish,
                          "freeze_latency": self.latency.snapshot()})

    def close(self, timeout=30.0):
        """Let an in-flight stitch finish, then stop the worker. Never
        blocks past ``timeout`` + the worker's poll beat: the sentinel is
        enqueued without blocking (a queued job may hold the one slot —
        the worker exits via the stop flag once it drains), and a worker
        that cannot finish in time is reported, not waited on forever."""
        if not self._stop.is_set():
            self._stop.set()
            try:
                self._jobs.put_nowait(None)
            except queue.Full:
                pass          # worker exits via _stop after the backlog
        self._worker.join(timeout)
        return not self._worker.is_alive()


__all__ = ["CheckpointFreezer", "FreezeError"]
