"""OnlineLearningLoop: the end-to-end continuous-learning process tree
(counterpart of paddle_tpu/online/loop.py).

The "millions of users" loop the original Paddle v2 etcd/Go stack was
built for, assembled from this repo's production pieces: a supervised
pserver fleet holds the parameters (checkpointed, restart-on-crash), a
StreamingTrainer consumes an unbounded reader and pushes gradients, a
CheckpointFreezer periodically takes a barrier-consistent cut and
publishes it to the ModelRegistry, and a RolloutController drives
canary-gated ``rolling_reload`` onto a supervised serving fleet — which
answers live inference traffic THE WHOLE TIME.

Supervision tree (everything under one object, one ``stop()``):

    OnlineLearningLoop
    ├── PserverSupervisor        n_pservers forked shards, per-shard
    │                            checkpoints, restart-on-crash
    ├── StreamingTrainer         in-process thread; retry-riding client
    ├── CheckpointFreezer        cut + stitch/publish worker thread
    ├── FleetSupervisor          n_replicas spawned ModelServers,
    │                            restart from the registry's current
    │                            version
    └── RolloutController        registry watcher -> rolling_reload

Chaos contract (pinned by the tier-1 e2e test and the bench lane): with
a pserver shard AND a serving replica SIGKILLed mid-loop, zero infer
requests fail (the FleetClient fails over; the supervisors restart the
children), the served version keeps advancing monotonically, and a
published-but-corrupt version is rolled back by the canary gate without
the fleet ever serving it.

Startup publishes version 1 (the freshly initialized params) BEFORE the
serving fleet boots, so replicas always have a version to load — and a
crash-restarting replica loads whatever is current by then.

Device: ``place`` (default: the card; ``fluid.CPUPlace()`` for the CPU)
is where the trainers' executors, the freezer's export and the serving
replicas run; without a card and without ``place`` the loop raises when it
is built, as ``core.executor.resolve_device`` does.
"""

from __future__ import annotations

import threading
import time


class _PublishPacer:
    """Publish cadence for the elastic pool: with N churning workers
    there is no single trainer whose step boundary can drive
    ``request_freeze``, so a loop-level thread owns the cadence instead
    — tick, check steps/seconds since the last ACCEPTED cut, freeze.
    A torn cut (workers push continuously; shard rounds can disagree
    for a moment) or a busy stitcher returns None and the pacer simply
    retries next tick — the cadence only resets on acceptance, exactly
    the StreamingTrainer contract."""

    def __init__(self, freezer, step_fn, every_steps, every_s,
                 tick_s=0.1):
        self._freezer = freezer
        self._step_fn = step_fn
        self._every_steps = int(every_steps or 0)
        self._every_s = float(every_s or 0.0)
        self._tick_s = float(tick_s)
        self.requests = 0
        self.accepted = 0
        self._pending = None
        self._stop = threading.Event()
        self._thread = None

    def _due(self, steps_since, last_t):
        if self._pending is not None and self._pending.done():
            failed = self._pending.failed()
            self._pending = None
            if failed:
                return True    # accepted cut died in its stitch: due now
        if self._every_steps > 0 and steps_since >= self._every_steps:
            return True
        if self._every_s > 0 and time.monotonic() - last_t >= self._every_s:
            return True
        return False

    def _run(self):
        last_step = self._step_fn()
        last_t = time.monotonic()
        while not self._stop.wait(self._tick_s):
            step = self._step_fn()
            if not self._due(step - last_step, last_t):
                continue
            self.requests += 1
            try:
                job = self._freezer.request_freeze(step)
            except RuntimeError:
                return         # freezer closed under us: stop pacing
            if job is not None:
                self.accepted += 1
                self._pending = job
                last_step = step
                last_t = time.monotonic()

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="publish-pacer")
        self._thread.start()
        return self

    def stop(self, timeout=10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def stats(self):
        return {"requests": self.requests, "accepted": self.accepted}


class OnlineLearningLoop:
    """Wire and supervise the full streaming-train -> publish -> rollout
    loop for one model.

        main, startup = build_model()        # optimizer.minimize applied
        loop = OnlineLearningLoop(
            main, startup, reader,
            infer_feed_names=["x"], infer_targets=[y_pred],
            registry_root=root, model="ranker",
            n_pservers=2, n_replicas=2)
        loop.start()
        ... FleetClient(loop.fleet.addresses) serves throughout ...
        loop.stats()
        loop.stop()

    ``main_program`` must carry optimize ops (``optimizer.minimize``) —
    the transpiler lifts the rule server-side and strips them from the
    trainer program; the SAME program exports the inference bundle
    (``save_inference_model`` prunes to the fetch path). ``place`` is the
    device of the trainers, the freezer's export and the replicas (the
    card unless the caller asks for the CPU).
    """

    def __init__(self, main_program, startup_program, reader,
                 infer_feed_names, infer_targets, registry_root,
                 model="model", n_pservers=2, n_replicas=None,
                 sync_mode=True, publish_every_steps=None,
                 publish_every_s=None, min_serve_s=None,
                 rollout_poll_s=None, registry_keep=None,
                 buckets=None, max_delay_ms=None, checkpoint_dir=None,
                 checkpoint_every=1, trainer_retry=None, extra_fetch=(),
                 prefetch=2, fleet_kwargs=None, slo_rules=None,
                 incident_dir=None, chunks=None, chunk_feeds=None,
                 chunks_per_task=1, master_timeout_s=3.0,
                 trainers_min=None, trainers_max=None, autoscale=True,
                 trainer_lease_s=None, place=None):
        from ..core.executor import resolve_device
        from ..serving.registry import ModelRegistry

        # elastic mode: ``chunks`` + ``chunk_feeds`` replace ``reader``
        # — a Master task queue feeds a TrainerPool of N workers (leased
        # membership, hot-join/retire, backlog autoscaling) instead of
        # one StreamingTrainer consuming one reader
        if (chunks is None) != (chunk_feeds is None):
            raise ValueError("elastic mode needs BOTH chunks and "
                             "chunk_feeds (or neither)")
        if chunks is not None and reader is not None:
            raise ValueError("pass either reader (single-trainer) or "
                             "chunks+chunk_feeds (elastic pool), not both")

        # the device every executor and replica of the loop runs on:
        # resolved here, so a loop without a card and without place
        # raises before it spawns anything
        resolve_device(place)
        self._place = place
        self._main = main_program
        self._startup = startup_program
        self._reader = reader
        self._feed_names = list(infer_feed_names)
        self._targets = [t if isinstance(t, str) else t.name
                         for t in infer_targets]
        self.registry = registry_root if isinstance(registry_root,
                                                    ModelRegistry) \
            else ModelRegistry(registry_root)
        self.model = model
        self._n_pservers = int(n_pservers)
        self._n_replicas = n_replicas
        self._sync_mode = bool(sync_mode)
        self._pub_steps = publish_every_steps
        self._pub_s = publish_every_s
        self._min_serve_s = min_serve_s
        self._rollout_poll_s = rollout_poll_s
        self._registry_keep = registry_keep
        self._buckets = buckets
        self._max_delay_ms = max_delay_ms
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = int(checkpoint_every)
        self._retry = trainer_retry
        self._extra_fetch = extra_fetch
        self._prefetch = prefetch
        self._fleet_kwargs = dict(fleet_kwargs or {})
        self._slo_rules = list(slo_rules or [])
        self._incident_dir = incident_dir
        self._chunks = list(chunks) if chunks is not None else None
        self._chunk_feeds = chunk_feeds
        self._chunks_per_task = int(chunks_per_task)
        self._master_timeout_s = float(master_timeout_s)
        self._trainers_min = trainers_min
        self._trainers_max = trainers_max
        self._autoscale = bool(autoscale)
        self._trainer_lease_s = trainer_lease_s
        self.pservers = None
        self.fleet = None
        self.trainer = None
        self.pool = None
        self.master = None
        self.master_rpc = None
        self.autoscaler = None
        self.pacer = None
        self.freezer = None
        self.rollout = None
        self.client = None
        self.slo_monitor = None
        self.incidents = None
        self._exe = None
        self._scope = None
        self._started = False

    # ------------------------------------------------------------------
    def start(self, wait_ready_s=240.0):
        """Boot the tree bottom-up: pservers -> init params -> publish
        v1 -> serving fleet -> rollout watcher -> trainer. Returns the
        initially served version."""
        from .. import fluid
        from ..distributed.launch import PserverSupervisor
        from ..distributed.rpc import RetryPolicy
        from ..obs.recorder import IncidentCollector
        from ..obs.slo import SloMonitor
        from ..serving.fleet import FleetSupervisor
        from .freezer import CheckpointFreezer
        from .rollout import RolloutController
        from .trainer import StreamingTrainer

        if self._started:
            raise RuntimeError("loop already started")
        self._started = True

        # transpile against placeholder endpoints — placement derives
        # from sorted param names + shard COUNT, so the real supervisor
        # addresses substitute at client construction
        t = fluid.DistributeTranspiler()
        t.transpile(0, program=self._main,
                    pservers=",".join(f"127.0.0.1:{i + 1}"
                                      for i in range(self._n_pservers)),
                    trainers=1, startup_program=self._startup,
                    sync_mode=self._sync_mode)
        self._transpiler = t

        self.pservers = PserverSupervisor(
            n_servers=self._n_pservers, checkpoint_dir=self._ckpt_dir,
            optimizer=t.optimizer, opt_kwargs=t.opt_kwargs,
            mode="sync" if self._sync_mode else "async", fan_in=1,
            checkpoint_every=self._ckpt_every,
            # elastic pool workers register membership leases, so the
            # sync barrier sizes itself to the LIVE worker set instead
            # of the static fan_in above (which stays the lease-less
            # fallback)
            trainer_lease_s=self._trainer_lease_s)
        try:
            if not self.pservers.wait_ready(wait_ready_s):
                raise RuntimeError("pserver shards never became ready")

            self._exe = fluid.Executor(self._place)
            self._scope = fluid.Scope()
            self._exe.run(self._startup, scope=self._scope)
            retry = self._retry or RetryPolicy(max_retries=8,
                                               backoff_base_s=0.05,
                                               backoff_max_s=1.0)
            self.client = t.trainer_client(retry=retry,
                                           endpoints=self.pservers.addresses)
            self.client.init_params(
                {p: self._scope.find_var(p).detach().cpu().numpy()
                 for p, _g in t.params_grads})

            self.freezer = CheckpointFreezer(
                self.client, self.registry, self.model, self._main,
                self._feed_names, self._targets, executor=self._exe,
                template_scope=self._scope)
            # v1: the initialized params — the fleet needs something to
            # serve before the first training-driven publish lands
            self.freezer.request_freeze(0, wait=True, timeout=wait_ready_s)

            self.fleet = FleetSupervisor(
                self.registry, self.model, version="latest",
                n_replicas=self._n_replicas, buckets=self._buckets,
                max_delay_ms=self._max_delay_ms,
                # the same declarative rules judge every replica's OWN
                # registry (surfaced via its health()) AND this process
                slo_rules=self._slo_rules or None, place=self._place,
                **self._fleet_kwargs)
            if not self.fleet.wait_ready(wait_ready_s):
                raise RuntimeError("serving fleet never became ready")

            # the actionable obs layer: one incident collector over the
            # WHOLE tree (pserver shards + serving replicas + this
            # process), triggered by child restarts, canary failures,
            # and SLO breaches — every chaos event leaves a fleet-wide
            # flight-recorder bundle behind
            self.incidents = IncidentCollector(
                addresses_fn=self._all_addresses,
                out_dir=self._incident_dir)
            self.pservers.incident_hook = self.incidents.trigger
            self.fleet.incident_hook = self.incidents.trigger
            if self._slo_rules:
                self.slo_monitor = SloMonitor(
                    self._slo_rules,
                    on_breach=self.incidents.trigger)
                self.slo_monitor.install()
                self.slo_monitor.start()

            self.rollout = RolloutController(
                self.registry, self.model, self.fleet,
                poll_interval_s=self._rollout_poll_s,
                min_serve_s=self._min_serve_s,
                rollout_timeout_s=wait_ready_s,
                registry_keep=self._registry_keep,
                incident_collector=self.incidents)
            self.rollout.start()

            if self._chunks is not None:
                self._start_elastic()
            else:
                self.trainer = StreamingTrainer(
                    self._exe, self._scope, t.get_trainer_program(),
                    t.params_grads, self.client, self._reader,
                    freezer=self.freezer,
                    publish_every_steps=self._pub_steps,
                    publish_every_s=self._pub_s,
                    extra_fetch=self._extra_fetch,
                    prefetch=self._prefetch)
                self.trainer.start()
        except Exception:
            self.stop()               # resets _started: retryable
            raise
        return self.fleet.version

    # ------------------------------------------------------------------
    def _start_elastic(self):
        """Elastic-mode trainer plane: an in-process Master dispatches
        the chunk queue over RPC, a TrainerPool of StreamingTrainer
        workers leases tasks from it (each with its own ParamClient and
        a pserver membership lease), a BacklogAutoscaler grows/shrinks
        the pool from the queue depth, and a publish pacer drives the
        freeze cadence — any worker may die at any point without losing
        a chunk (Master lease re-dispatch) or stalling a barrier
        (pserver lease shrink)."""
        from ..core.flags import get_flag
        from ..distributed.master import Master
        from ..distributed.rpc import RpcServer
        from .pool import BacklogAutoscaler, TrainerPool

        self.master = Master(timeout_s=self._master_timeout_s)
        self.master_rpc = RpcServer(self.master)
        self.master_rpc.serve_in_thread()
        self.master.set_dataset(self._chunks,
                                chunks_per_task=self._chunks_per_task)

        self.pool = TrainerPool(self._spawn_trainer,
                                min_workers=self._trainers_min,
                                max_workers=self._trainers_max)
        self.pool.incident_hook = self.incidents.trigger
        self.pool.start()
        if self._autoscale:
            self.autoscaler = BacklogAutoscaler(self.pool,
                                                self.master.backlog)
            self.autoscaler.start()
        pub_steps = self._pub_steps if self._pub_steps is not None \
            else int(get_flag("online_publish_every_steps"))
        pub_s = self._pub_s if self._pub_s is not None \
            else float(get_flag("online_publish_every_s"))
        self.pacer = _PublishPacer(self.freezer, self.pool.global_step,
                                   pub_steps, pub_s)
        self.pacer.start()

    def _spawn_trainer(self, wid, stop_ev):
        """TrainerPool spawn hook: a startable StreamingTrainer with its
        OWN scope/executor/ParamClient (unique trainer id — the lease
        and dedup identity) over a stop-aware Master task reader.
        ``prefetch=0`` is load-bearing: the reader marks a task finished
        only when asked for the batch AFTER its last one, which without
        read-ahead is exactly when every batch's push has acked."""
        from .. import fluid
        from ..distributed.param_server import ParamClient
        from ..distributed.rpc import RetryPolicy
        from .pool import master_task_reader
        from .trainer import StreamingTrainer

        t = self._transpiler
        scope = fluid.Scope()
        exe = fluid.Executor(self._place)
        exe.run(self._startup, scope=scope)   # shapes; pull overwrites
        retry = self._retry or RetryPolicy(max_retries=8,
                                           backoff_base_s=0.05,
                                           backoff_max_s=1.0)
        client = ParamClient(
            [tuple(a) for a in self.pservers.addresses],
            trainer_id=f"elastic-w{wid}",
            param_names=[p for p, _g in t.params_grads],
            sparse_param_names=t.sparse_param_names, retry=retry)
        reader = master_task_reader(self.master_rpc.address,
                                    self._chunk_feeds, stop=stop_ev,
                                    membership=client)
        return StreamingTrainer(exe, scope, t.get_trainer_program(),
                                t.params_grads, client, reader,
                                freezer=None,       # the pacer publishes
                                publish_every_steps=0, publish_every_s=0,
                                extra_fetch=self._extra_fetch, prefetch=0)

    # ------------------------------------------------------------------
    def _all_addresses(self):
        addrs = []
        if self.fleet is not None:
            addrs += [tuple(a) for a in self.fleet.addresses]
        if self.pservers is not None:
            addrs += [tuple(a) for a in self.pservers.addresses]
        return addrs

    # ------------------------------------------------------------------
    def stats(self, fleet_metrics=True, scrape_timeout=1.0):
        """One aggregated observability surface: every component's
        counters plus the supervisors' per-child restart stats — what an
        operator (and the bench lane) watches the loop through.

        ``fleet_metrics=True`` additionally scrapes the built-in
        ``metrics`` RPC of every pserver shard and serving replica and
        merges those registry snapshots with this process's own (the
        trainer/freezer/rollout counters live HERE) into one fleet-wide
        view under ``"metrics"`` — unreachable children (mid-restart)
        are skipped, never waited on past ``scrape_timeout``."""
        from ..obs import metrics as _m

        out = {"model": self.model, "started": self._started}
        if self.trainer is not None:
            out["trainer"] = self.trainer.stats()
        if self.pool is not None:
            out["pool"] = self.pool.stats()
        if self.master is not None:
            out["backlog"] = self.master.backlog()
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        if self.pacer is not None:
            out["publish_pacer"] = self.pacer.stats()
        if self.freezer is not None:
            out["freezer"] = self.freezer.stats()
        if self.rollout is not None:
            out["rollout"] = self.rollout.stats()
        if self.fleet is not None:
            out["served_version"] = self.fleet.version
            out["fleet_children"] = self.fleet.child_stats()
        if self.pservers is not None:
            out["pserver_children"] = self.pservers.child_stats()
        try:
            out["published_versions"] = self.registry.versions(self.model)
        except ValueError:
            out["published_versions"] = []
        if self.slo_monitor is not None:
            out["slo"] = self.slo_monitor.health_section()
        if self.incidents is not None:
            out["incidents"] = self.incidents.stats()
        if fleet_metrics:
            addrs = self._all_addresses()
            scraped = _m.scrape(addrs, timeout=scrape_timeout) \
                if addrs else {}
            out["metrics"] = _m.merge_snapshots(
                [_m.REGISTRY.snapshot()] + list(scraped.values()))
        return _m.json_safe(out)

    def stop(self):
        """Tear the tree down top-down (trainer first so nothing pushes
        into stopping shards; fleet before pservers so no component is
        surprised). Idempotent, and resets the started flag: a stopped
        loop can be start()ed again from scratch (every component is
        rebuilt there)."""
        if self.autoscaler is not None:
            self.autoscaler.stop()
            self.autoscaler = None
        if self.pacer is not None:
            self.pacer.stop()
            self.pacer = None
        if self.pool is not None:
            self.pool.stop()
            self.pool = None
        if self.master_rpc is not None:
            self.master_rpc.shutdown()
            self.master_rpc = None
            self.master = None
        if self.trainer is not None:
            self.trainer.stop()
            self.trainer = None
        if self.rollout is not None:
            self.rollout.stop()
            self.rollout = None
        if self.slo_monitor is not None:
            from ..obs import slo as _slo
            self.slo_monitor.stop()
            if _slo.installed() is self.slo_monitor:
                _slo.install(None)
            self.slo_monitor = None
        if self.incidents is not None:
            # detach the hooks first so a child dying during teardown
            # doesn't race a capture into the closing fleet
            if self.pservers is not None:
                self.pservers.incident_hook = None
            if self.fleet is not None:
                self.fleet.incident_hook = None
            self.incidents.wait_idle(timeout=5.0)
            self.incidents = None
        if self.freezer is not None:
            self.freezer.close()
            self.freezer = None
        if self.fleet is not None:
            self.fleet.stop()
            self.fleet = None
        if self.client is not None:
            self.client.close()
            self.client = None
        if self.pservers is not None:
            self.pservers.stop()
            self.pservers = None
        self._started = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


__all__ = ["OnlineLearningLoop"]
