"""FleetSupervisor: a supervised fleet of ModelServer replicas with
zero-downtime rolling version rollouts (counterpart of
paddle_tpu/serving/fleet.py).

The inference-plane transplant of the training plane's supervision design
(``distributed/launch.py``): the shared :class:`ChildSupervisor` loop
forks/heartbeats/restarts children on FIXED addresses; this subclass
contributes the replica child — resolve the registry's CURRENT version,
warm every bucket BEFORE binding the address (so a restarting replica is
never half-ready: until it binds, health probes fail fast and the router
keeps it ejected), then serve. A replica that crashes restarts from the
registry's current version, which after a rollout is the NEW version —
the registry is the source of truth, not the dead process.

Replicas are SPAWNED, never forked: each is a fresh interpreter
(``distributed/launch.py``'s child boot), because a forked child would
inherit the parent's CUDA context in an unusable state (PyTorch does not
support CUDA in a forked child). The child pins its device from the child
config (the parent's ``place``: the card unless the caller asked for the
CPU) and takes the parent's kernel route, autotune switches and TF32
switches, so its replies are the parent's engine's bitwise. Spawn pays an
interpreter + torch import + CUDA context + warmup startup cost, which is
why ``startup_grace_s`` defaults high here. Build the kernels once in the
parent before spawning (``ops/cuda/build.py``): replicas that start
together would otherwise each run every missing ``nvcc`` build. Each
replica reports its kernel launches through ``replica_stats`` (the
engine's ``kernel_launches``), so the parent sees the kernels ran in the
child.

``rolling_reload(version)`` is the rollout: one replica at a time, ask it
to hot-reload (``ModelServer.reload`` builds + warms the new engine OFF
the hot path, so the replica keeps serving throughout — the fleet never
drops below N−1 ready, and in the healthy path never below N), then
health-gate (serving + warmed + reporting the target version) before
moving on. Replica 0 is the CANARY: only after it passes does the
supervisor's current version advance (so mid-rollout crash-restarts pick
the right side of the rollout), and a failed canary is rolled back to the
previous manifest version and the rollout aborted — N−1 replicas never
even saw the bad version.

Warm starts: a replica's model_dir IS the registry version dir, so when
the version was published with ``warm_cache=True`` (or ``registry.
warm()`` ran later) the spawned child finds the ``warm/`` executable
artifacts right next to the bundle and its warmup LOADS them instead of
compiling (serving/execcache.py) — scale-out spawns, crash restarts and
``rolling_reload`` targets all skip their warmup compiles. The
``serving_exec_cache`` / ``serving_exec_cache_dir`` flag values ride the
child config so the whole fleet follows the parent's configuration, and
so do ``serving_kv_spill_dir`` / ``serving_kv_spill_bytes`` — a version
published with ``kv_prompts`` carries its ``kv/`` prefix chains next to
the bundle the same way (serving/generate/kvstore.py).
"""

from __future__ import annotations

import threading
import time

from ..core.flags import get_flag
from ..core.profiler import trace_context
from ..distributed.launch import ChildSupervisor
from ..distributed.rpc import RemoteError, RpcClient
from ..obs import recorder as _flight
from .registry import ModelRegistry


class CanaryFailed(RuntimeError):
    """``rolling_reload``'s canary (replica 0) REJECTED the target
    version and was rolled back — the TARGET IS BAD (corrupt bundle,
    failed warmup), not the fleet: N−1 replicas never saw it. Raised
    only when the canary ANSWERED with a structured RemoteError (it
    processed the reload and refused); a canary that is merely
    unreachable (crashed / killed mid-reload) raises a plain
    RuntimeError instead — that says nothing about the bundle. Typed so
    an automated rollout driver (online.RolloutController) can mark the
    version bad and never retry it, while transient failures (plain
    RuntimeError, canary unreachable or mid-fleet after the canary
    passed) stay retryable.
    ``version`` carries the rejected target, ``rolled_back_to`` the
    version the canary was restored to (None when there was nothing to
    roll back to)."""

    def __init__(self, message, version=None, rolled_back_to=None):
        super().__init__(message)
        self.version = version
        self.rolled_back_to = rolled_back_to


def _replica_child(address, model_dir, version, cfg, fault_plan=None):
    """Spawned child entry: pin the device and the parent's switches
    before any engine exists, build + WARM the engine, and only then bind
    the fixed address and serve — health-gating for free: an unbound
    replica is loudly dead, never silently cold."""
    import torch

    from .. import fluid  # noqa: F401  (registers every op lowering)
    from ..core.executor import CPUPlace, CUDAPlace
    from ..core.flags import set_flags
    from .engine import InferenceEngine
    from .server import ModelServer

    dev = torch.device(cfg.get("device", "cuda:0"))
    place = CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)
    tf32 = cfg.get("tf32") or {}
    if "matmul" in tf32:
        torch.backends.cuda.matmul.allow_tf32 = bool(tf32["matmul"])
    if "cudnn" in tf32:
        torch.backends.cudnn.allow_tf32 = bool(tf32["cudnn"])
    # spawned children start with default flags: ship the parent's route,
    # autotune, exec-cache and KV-spill switches so the whole fleet agrees
    # (model_dir is the registry version dir, so published warm/, kv/
    # and tune/ sidecars are found right next to the bundle)
    set_flags({"kernel_tier": cfg.get("kernel_tier", "auto"),
               "kernel_autotune": cfg.get("kernel_autotune", True),
               "kernel_autotune_bf16": cfg.get("kernel_autotune_bf16",
                                               False),
               "serving_exec_cache": cfg.get("exec_cache", True),
               "serving_exec_cache_dir": cfg.get("exec_cache_dir", ""),
               "serving_kv_spill_dir": cfg.get("kv_spill_dir", ""),
               "serving_kv_spill_bytes": cfg.get("kv_spill_bytes", 0)})
    engine = InferenceEngine(model_dir, place=place,
                             buckets=cfg.get("buckets"))
    engine.warmup()
    server = ModelServer(
        engine=engine, model_dir=model_dir, address=tuple(address),
        batching=cfg.get("batching", True),
        max_delay_ms=cfg.get("max_delay_ms"),
        queue_capacity=cfg.get("queue_capacity"),
        fault_plan=fault_plan, version=version,
        # SLO rules ride the child config as plain dicts; the server
        # builds + installs its own SloMonitor
        slo_rules=cfg.get("slo_rules"))
    server.serve_forever(warmup=False)


class FleetSupervisor(ChildSupervisor):
    """Supervise N ModelServer replicas serving one registry model.

        reg = ModelRegistry(root); reg.publish("ranker", export_dir)
        with FleetSupervisor(root, "ranker", n_replicas=2) as sup:
            sup.wait_ready(120)
            client = FleetClient(sup.addresses)
            ...
            sup.rolling_reload(2)      # zero-downtime rollout to v2

    ``fault_plans`` maps replica index -> FaultPlan, applied on the FIRST
    spawn only (a restarted replica comes back clean — otherwise the
    schedule would re-fire every restart and the replica could never
    rejoin). ``n_replicas`` defaults from the ``serving_fleet_replicas``
    flag. ``place`` is the replicas' device (the card unless the caller
    asks for the CPU)."""

    def __init__(self, registry_root, model, version="latest",
                 n_replicas=None, batching=True, buckets=None,
                 max_delay_ms=None, queue_capacity=None,
                 heartbeat_interval_s=0.25, heartbeat_timeout_s=None,
                 heartbeat_misses=3, max_restarts=5, startup_grace_s=120.0,
                 fault_plans=None, host="127.0.0.1", slo_rules=None,
                 place=None):
        from ..core.executor import resolve_device
        from ..obs.slo import SloRule
        from .execcache import tf32_switches

        self.registry = registry_root if isinstance(registry_root,
                                                    ModelRegistry) \
            else ModelRegistry(registry_root)
        self.model = model
        _path, v = self.registry.resolve(model, version)
        self._version = v
        self._version_lock = threading.Lock()
        # validate rules HERE (a bad rule must fail the supervisor, not
        # crash-loop every spawned child); ship the dict form
        slo_dicts = [r.to_dict() if isinstance(r, SloRule)
                     else SloRule.from_dict(r).to_dict()
                     for r in (slo_rules or [])] or None
        # the replicas' device: the card unless the caller asks for the
        # CPU (raises here, not in every child, where no card is present)
        device = resolve_device(place)
        self._cfg = dict(batching=batching, buckets=buckets,
                         max_delay_ms=max_delay_ms,
                         queue_capacity=queue_capacity,
                         slo_rules=slo_dicts,
                         device=str(device),
                         # the route, the tuner's switches and the TF32
                         # switches change the replies' bits: the
                         # replicas take the parent's
                         kernel_tier=str(get_flag("kernel_tier")),
                         kernel_autotune=bool(get_flag("kernel_autotune")),
                         kernel_autotune_bf16=bool(
                             get_flag("kernel_autotune_bf16")),
                         tf32=tf32_switches(),
                         # exec-cache and KV-spill switches ride the
                         # child config: spawn = fresh default flags
                         exec_cache=bool(get_flag("serving_exec_cache")),
                         exec_cache_dir=str(
                             get_flag("serving_exec_cache_dir")),
                         kv_spill_dir=str(get_flag("serving_kv_spill_dir")),
                         kv_spill_bytes=int(
                             get_flag("serving_kv_spill_bytes")))
        self._fault_plans = dict(fault_plans or {})
        if n_replicas is None:
            n_replicas = int(get_flag("serving_fleet_replicas"))
        super().__init__(
            int(n_replicas), heartbeat_method="health",
            heartbeat_interval_s=heartbeat_interval_s,
            heartbeat_timeout_s=heartbeat_timeout_s,
            heartbeat_misses=heartbeat_misses, max_restarts=max_restarts,
            startup_grace_s=startup_grace_s, host=host)

    # ------------------------------------------------------------------
    @property
    def version(self):
        """The fleet's CURRENT target version — what a restarted replica
        comes back serving."""
        with self._version_lock:
            return self._version

    def _obs_name(self):
        # flight-recorder component label; getattr because structural
        # tests build supervisors via __new__ without the obs instance
        return getattr(self, "obs_instance", type(self).__name__)

    def _child_spec(self, i):
        with self._version_lock:
            v = self._version
        path, v = self.registry.resolve(self.model, v)
        plan = self._fault_plans.pop(i, None)   # first spawn only
        return _replica_child, (self.addresses[i], path, v, self._cfg,
                                plan)

    # ------------------------------------------------------------------
    def replica_health(self, i, timeout=2.0):
        """One health RPC to replica ``i`` — None when unreachable."""
        c = RpcClient(self.addresses[i], timeout=timeout)
        try:
            return c.call("health")
        except Exception:
            return None
        finally:
            c.close()

    def ready_count(self, timeout=2.0):
        """How many replicas currently answer health as serving+warmed —
        what the rollout invariant (never below N−1) is measured in."""
        n = 0
        for i in range(len(self.addresses)):
            h = self.replica_health(i, timeout=timeout)
            if h is not None and h.get("status") == "serving" \
                    and h.get("warmed"):
                n += 1
        return n

    def _await_replica(self, i, deadline, target_version=None):
        """Wait for replica ``i`` to answer health (optionally on a given
        version) — rides out a concurrent crash-restart mid-rollout."""
        while True:
            h = self.replica_health(i)
            if h is not None and h.get("status") == "serving" \
                    and h.get("warmed") \
                    and (target_version is None
                         or h.get("version") == target_version):
                return h
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"replica {i} at {self.addresses[i]} did not become "
                    f"ready (last health: {h})")
            time.sleep(0.1)

    def _reload_replica(self, i, path, version, timeout):
        """Ask replica ``i`` to hot-swap, then health-gate the result.
        Returns None on success, the failure on any error. The whole
        exchange runs under ONE trace id, and the decision lands in this
        process's flight recorder under it — the replica records its
        ``reload`` event under the SAME id server-side, so an incident
        bundle links the rollout decision to its execution across the
        two processes."""
        c = RpcClient(self.addresses[i], timeout=timeout)
        try:
            with trace_context():
                _flight.record("replica_reload",
                               component=self._obs_name(),
                               replica=i, version=version)
                h = c.call("health")
                if h.get("version") != version:
                    # a replica that crash-restarted AFTER the version
                    # advanced already serves the target; reloading it
                    # again is harmless but wasteful
                    c.call("reload", model_dir=path, version=version)
                h = c.call("health")
            if not (h.get("status") == "serving" and h.get("warmed")
                    and h.get("version") == version):
                return RuntimeError(f"replica {i} unhealthy after reload: "
                                    f"{h}")
            return None
        except Exception as e:
            return e
        finally:
            c.close()

    def rolling_reload(self, version, wait_timeout=120.0):
        """Zero-downtime rollout to ``version`` (any :meth:`~.registry.
        ModelRegistry.resolve` spelling): reload one health-gated replica
        at a time. Replica 0 is the canary — on its failure the canary is
        rolled back to the PREVIOUS version and the rollout aborts with a
        RuntimeError (the rest of the fleet never saw the bad version).
        After the canary passes, the supervisor's current version
        advances, so a replica that crashes mid-rollout restarts straight
        onto the target. Returns the rolled-out version."""
        path, target = self.registry.resolve(self.model, version)
        prev = self.version
        for i in range(len(self.addresses)):
            deadline = time.monotonic() + wait_timeout
            self._await_replica(i, deadline)
            err = self._reload_replica(i, path, target,
                                       timeout=wait_timeout)
            if err is not None:
                if i == 0:
                    self._rollback_canary(prev, wait_timeout)
                    _flight.record(
                        "canary_failed", component=self._obs_name(),
                        version=target, rolled_back_to=prev,
                        error=f"{type(err).__name__}: {err}",
                        condemned=isinstance(err, RemoteError))
                    if isinstance(err, RemoteError):
                        # the canary ANSWERED with a structured error —
                        # it processed the reload and rejected the bundle
                        # (corrupt files, failed warmup): the TARGET is
                        # bad. Typed so rollout drivers quarantine it.
                        raise CanaryFailed(
                            f"rolling_reload: canary (replica 0) rejected "
                            f"version {target}; rolled back to {prev}: "
                            f"{type(err).__name__}: {err}",
                            version=target, rolled_back_to=prev) from err
                    # connection-level failure (canary crashed / was
                    # killed mid-reload, connect refused during its
                    # restart): says nothing about the bundle — plain
                    # RuntimeError, retryable once the supervisor
                    # restarts the replica
                    raise RuntimeError(
                        f"rolling_reload: canary (replica 0) unreachable "
                        f"during rollout to {target} (rolled back to "
                        f"{prev}); target not condemned — retry: "
                        f"{type(err).__name__}: {err}") from err
                raise RuntimeError(
                    f"rolling_reload: replica {i} failed after the canary "
                    f"passed — fleet is mixed-version (replicas <{i} on "
                    f"{target}, rest on {prev}): "
                    f"{type(err).__name__}: {err}") from err
            if i == 0:
                _flight.record("canary_passed",
                               component=self._obs_name(),
                               version=target)
                with self._version_lock:
                    self._version = target
        _flight.record("rollout_complete", component=self._obs_name(),
                       version=target, replicas=len(self.addresses))
        return target

    def _rollback_canary(self, prev_version, wait_timeout):
        try:
            ppath, pv = self.registry.resolve(self.model, prev_version)
        except ValueError:
            return   # nothing to roll back to (first ever version)
        # best-effort: in the common corrupt-bundle case the canary never
        # swapped (reload failures keep the old engine serving), so even a
        # failed rollback RPC leaves it on prev; the main raise carries
        # the canary failure detail either way
        self._reload_replica(0, ppath, pv, timeout=wait_timeout)

    def spawn_replica(self, wait_timeout=None):
        """Scale OUT by one replica: a fresh supervised child on a new
        fixed address, serving the registry's CURRENT version (its
        model_dir is the version dir, so published ``warm/`` artifacts
        make the spawn a warm start). ``wait_timeout`` health-gates the
        new replica (serving + warmed + current version) before
        returning — the autoscaler's canary gate. Returns ``(index,
        address)``."""
        address = self.add_child()
        i = len(self.addresses) - 1
        _flight.record("replica_spawned", component=self._obs_name(),
                       replica=i, address=address,
                       version=self.version)
        if wait_timeout is not None:
            deadline = time.monotonic() + float(wait_timeout)
            self._await_replica(i, deadline,
                                target_version=self.version)
        return i, address

    def retire_replica(self, timeout=10.0):
        """Scale IN by one replica (always the highest index — surviving
        replicas keep their addresses). Returns the retired address."""
        address = self.retire_child(timeout=timeout)
        _flight.record("replica_retired", component=self._obs_name(),
                       address=address,
                       replicas=len(self.addresses))
        return address

    def replica_stats(self, timeout=5.0):
        """stats() from every reachable replica (index -> stats|None) —
        what the bench lane aggregates hot_recompiles/version over."""
        out = {}
        for i in range(len(self.addresses)):
            c = RpcClient(self.addresses[i], timeout=timeout)
            try:
                out[i] = c.call("stats")
            except Exception:
                out[i] = None
            finally:
                c.close()
        return out

    def fleet_metrics(self, timeout=2.0, include_local=True):
        """Fleet-wide obs.metrics scrape: the built-in ``metrics`` RPC
        from every replica (index -> registry snapshot, None when
        unreachable) plus this supervisor process's OWN registry
        (restart counters, router/client series) when ``include_local``,
        merged per :func:`~..obs.metrics.merge_snapshots`
        (counters/gauges sum; histogram percentiles take the
        conservative max). What ``tools/metrics_dump.py --fleet`` and
        ``OnlineLearningLoop.stats()`` read."""
        from ..obs import metrics as _m

        from ..obs import slo as _slo

        scraped = _m.scrape(self.addresses, timeout=timeout)
        replicas = {i: scraped.get(tuple(a))
                    for i, a in enumerate(self.addresses)}
        snaps = list(replicas.values())
        if include_local:
            snaps.append(_m.REGISTRY.snapshot())
        merged = _m.merge_snapshots(snaps)
        out = {"replicas": replicas, "merged": merged}
        # per-replica serving queue depth, FIRST-CLASS: the batchers
        # maintain the paddle_tpu_server_queue_depth gauge on every
        # enqueue/dequeue, so this is an O(1) read off the snapshot just
        # scraped — no stats() RPC, no re-derivation from batcher dicts.
        # The autoscaler's second control signal next to SLO burn rate.
        depths = {}
        for i, snap in replicas.items():
            if not snap:
                depths[i] = None
                continue
            fam = snap.get("paddle_tpu_server_queue_depth") or {}
            depths[i] = sum(v.get("value", 0)
                            for v in fam.get("values", ()))
        out["queue_depth"] = {
            "replicas": depths,
            "total": sum(d for d in depths.values() if d is not None),
        }
        # SLO verdicts over the FLEET view: the process-installed
        # monitor's rules re-judged against the merged snapshot — via a
        # THROWAWAY monitor so the one-shot never pollutes the
        # background monitor's windowed burn state (a fresh state's
        # single sample makes this the instantaneous fleet verdict).
        # Rate rules need TWO samples for a counter delta, so a fresh
        # one-shot would silently report them ok=burn-0 — they are
        # surfaced as unmeasurable instead of falsely green.
        mon = _slo.installed()
        if mon is not None:
            instant = [r.to_dict() for r in mon.rules
                       if r.reducer != "rate"]
            fleet_view = _slo.SloMonitor(
                instant, emit_metrics=False).evaluate_once(merged) \
                if instant else {}
            for r in mon.rules:
                if r.reducer == "rate":
                    fleet_view[r.name] = {
                        "ok": None,
                        "unmeasurable": "rate rules need two samples; "
                                        "see the background monitor"}
            out["slo"] = {"local": mon.health_section(),
                          "fleet": fleet_view}
        # host-identity stamps: records are only comparable across hosts
        # when the accelerator identity rides every one
        import torch
        cuda = torch.cuda.is_available()
        out["n_devices"] = torch.cuda.device_count() if cuda else 1
        out["device_kind"] = torch.cuda.get_device_name(0) if cuda \
            else "cpu"
        return _m.json_safe(out)


__all__ = ["FleetSupervisor", "CanaryFailed"]
