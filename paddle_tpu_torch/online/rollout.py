"""RolloutController: registry watcher driving canary-gated fleet
rollouts with hysteresis and automatic bad-version quarantine (counterpart
of paddle_tpu/online/rollout.py).

The serving half of the online loop's control plane. A background thread
polls the ModelRegistry for versions newer than what the fleet serves
and drives ``FleetSupervisor.rolling_reload`` — with three safeguards a
naive "always roll latest" watcher lacks:

* **min-serve-time hysteresis** (``online_min_serve_s``): a new rollout
  never starts until the current version has served that long, so a
  flapping trainer publishing every few steps cannot churn the fleet;
  intermediate versions are skipped (the controller always targets the
  NEWEST eligible version, not the next one).
* **bad-version quarantine**: a :class:`~..serving.fleet.CanaryFailed`
  rollout (the canary ANSWERED and rejected the bundle, then was rolled
  back) marks that version bad FOREVER — it is never retried, the fleet
  keeps serving the previous version, and the loop advances only when
  the trainer publishes a newer good version. Transient failures — the
  canary merely unreachable (killed mid-reload; restarting), or a
  replica crash after the canary passed — surface as plain
  RuntimeErrors and condemn nothing: crashed replicas restart onto the
  current version, and an alive-but-stale replica (reload RPC failed,
  replica kept serving the old engine) is reconverged by re-driving
  ``rolling_reload`` at the served version on a later poll.
* **monotonic targets**: the controller only rolls FORWARD (target >
  served). Rollback exists solely as the canary's safety net inside
  ``rolling_reload``; the served version as reported by the supervisor
  never regresses.

Observability: ``stats()`` carries rollout/rollback counters, the
quarantine set, and a publish-to-served lag window (wall-clock from the
manifest's ``published_at`` to rollout completion — the end-to-end
freshness metric of the whole loop). With ``online_registry_keep`` > 0
the controller garbage-collects the registry after each successful
rollout, pinning the version it just served.
"""

from __future__ import annotations

import threading
import time

from ..core.flags import get_flag
from ..obs.metrics import (REGISTRY as _METRICS, json_safe,
                           next_instance)
from ..obs.recorder import record as _flight_record
from ..serving.fleet import CanaryFailed

# rollout outcomes in the obs.metrics registry: ok / canary_failed
# (quarantined) / error (transient) / converge_repair — stats() derives
# its counters from these children
_M_ROLLOUTS = _METRICS.counter(
    "paddle_tpu_online_rollouts",
    "RolloutController outcomes (ok, canary_failed, error, "
    "converge_repair), per instance", labels=("instance", "outcome"))
_M_GC_DELETED = _METRICS.counter(
    "paddle_tpu_online_registry_gc_deleted",
    "registry versions garbage-collected after rollouts, per instance",
    labels=("instance",))
_M_PUBLISH_TO_SERVED = _METRICS.histogram(
    "paddle_tpu_online_publish_to_served_seconds",
    "publish-to-served lag window (manifest published_at -> rollout "
    "complete), per instance", labels=("instance",),
    span_name="online/publish_to_served", span_kind="online")


class RolloutController:
    """Watch ``registry`` and keep ``supervisor`` on the newest good
    version.

        ctl = RolloutController(registry, "ranker", fleet_sup)
        ctl.start()
        ... ctl.stats() ...
        ctl.stop()
    """

    def __init__(self, registry, model, supervisor, poll_interval_s=None,
                 min_serve_s=None, rollout_timeout_s=120.0,
                 registry_keep=None, incident_collector=None,
                 warm_cache=False, warm_kwargs=None):
        self._registry = registry
        self._model = model
        self._sup = supervisor
        # warm_cache: before rolling a target version out, build its
        # persistent compiled-executable artifacts (registry.warm) so
        # every replica's reload warmup LOADS instead of compiles — the
        # controller pays each compile once, the fleet pays none. Best
        # effort: a failed warm never blocks the rollout (replicas just
        # compile as before). The artifacts must be built for the
        # FLEET'S engine geometry or every replica would silently miss:
        # warm_kwargs overrides, else the supervisor's configured
        # buckets are threaded through.
        self._warm_cache = bool(warm_cache)
        self._warm_kwargs = dict(warm_kwargs or {})
        if self._warm_cache and "buckets" not in self._warm_kwargs \
                and "gen_opts" not in self._warm_kwargs:
            buckets = getattr(supervisor, "_cfg", {}).get("buckets")
            if buckets is not None:
                self._warm_kwargs["buckets"] = buckets
        # obs.recorder.IncidentCollector (or any callable-bearing twin):
        # a canary failure triggers a fleet-wide flight-recorder bundle
        self._incidents = incident_collector
        if poll_interval_s is None:
            poll_interval_s = float(get_flag("online_rollout_poll_ms")) / 1e3
        if min_serve_s is None:
            min_serve_s = float(get_flag("online_min_serve_s"))
        if registry_keep is None:
            registry_keep = int(get_flag("online_registry_keep"))
        self._poll_s = float(poll_interval_s)
        self._min_serve_s = float(min_serve_s)
        self._timeout = float(rollout_timeout_s)
        self._keep = int(registry_keep)
        self._bad = set()
        self._lock = threading.Lock()
        self._needs_converge = False
        self._last_error = None
        self._last_rollout_t = None
        # outcome counters + lag window in the obs.metrics registry
        self.obs_instance = next_instance("rollout")
        self._m_ok = _M_ROLLOUTS.labels(instance=self.obs_instance,
                                        outcome="ok")
        self._m_canary = _M_ROLLOUTS.labels(instance=self.obs_instance,
                                            outcome="canary_failed")
        self._m_errors = _M_ROLLOUTS.labels(instance=self.obs_instance,
                                            outcome="error")
        self._m_converge = _M_ROLLOUTS.labels(instance=self.obs_instance,
                                              outcome="converge_repair")
        self._m_gc = _M_GC_DELETED.labels(instance=self.obs_instance)
        self.publish_to_served = _M_PUBLISH_TO_SERVED.labels(
            instance=self.obs_instance)
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("rollout controller already running")
        self._stop.clear()
        # hysteresis measures SERVE time, and the initial version started
        # serving when the fleet came up — so the clock starts now, not
        # at the first rollout
        self._last_rollout_t = time.monotonic()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="rollout-controller")
        self._thread.start()
        return self

    def stop(self, timeout=None):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self._timeout + 5.0
                              if timeout is None else timeout)
            return not self._thread.is_alive()
        return True

    # ------------------------------------------------------------------
    def _eligible_target(self):
        """Newest published version that is newer than served and not
        quarantined — None when the fleet is already current."""
        try:
            versions = self._registry.versions(self._model)
        except ValueError:
            return None
        served = self._sup.version
        good = [v for v in versions if v > served and v not in self._bad]
        return good[-1] if good else None

    def _maybe_reconverge(self):
        """A transient failure AFTER the canary passed leaves the
        supervisor's version advanced past a replica that is alive but
        stale (a failed reload RPC on a healthy replica leaves it
        serving the old engine — the crash-restart path never touches
        it). The forward-only eligibility filter cannot see this
        (served == target), so after any transient rollout error,
        re-drive ``rolling_reload`` AT the served version until every
        replica reports it; replicas already on it are skipped."""
        if not self._needs_converge:
            return
        served = self._sup.version
        mixed = False
        for i in range(len(self._sup.addresses)):
            h = self._sup.replica_health(i)
            if h is None or h.get("version") != served:
                mixed = True
                break
        if not mixed:
            self._needs_converge = False
            return
        try:
            self._sup.rolling_reload(served, wait_timeout=self._timeout)
            self._m_converge.inc()
            self._needs_converge = False
        except Exception as e:
            self._m_errors.inc()
            with self._lock:
                self._last_error = f"converge: {type(e).__name__}: {e}"

    def _poll(self):
        target = self._eligible_target()
        if target is None:
            self._maybe_reconverge()
            return
        if (time.monotonic() - self._last_rollout_t) < self._min_serve_s:
            return                       # hysteresis: let the fleet serve
        if self._warm_cache:
            try:
                self._registry.warm(self._model, target,
                                    **self._warm_kwargs)
            except Exception as e:
                # the warm is an optimization, not a gate: replicas
                # compile exactly as before when artifacts are absent
                with self._lock:
                    self._last_error = f"warm: {type(e).__name__}: {e}"
        try:
            self._sup.rolling_reload(target, wait_timeout=self._timeout)
        except CanaryFailed as e:
            self._m_canary.inc()
            _flight_record("canary_quarantine",
                           component=self.obs_instance, version=target,
                           rolled_back_to=e.rolled_back_to)
            with self._lock:
                self._bad.add(target)
                self._last_error = f"CanaryFailed: {e}"
            if self._incidents is not None:
                self._incidents.trigger(
                    "canary_failed",
                    detail={"version": target,
                            "rolled_back_to": e.rolled_back_to})
            return
        except Exception as e:
            # transient (canary unreachable; mid-fleet failure after the
            # canary passed; a replica crash-restarting concurrently):
            # crashed replicas restart onto the current version, and
            # _maybe_reconverge re-drives any alive-but-stale replica
            # the restart path would never touch
            self._m_errors.inc()
            with self._lock:
                self._last_error = f"{type(e).__name__}: {e}"
            self._needs_converge = True
            return
        now = time.monotonic()
        lag = None
        try:
            published_at = self._registry.manifest(
                self._model, target).get("published_at")
            if published_at is not None:
                lag = max(0.0, time.time() - float(published_at))
        except ValueError:
            pass
        self._m_ok.inc()
        with self._lock:
            self._last_rollout_t = now
            if lag is not None:
                self.publish_to_served.record(lag)
        if self._keep > 0:
            try:
                deleted = self._registry.gc(self._model,
                                            keep_latest=self._keep,
                                            pinned={target})
                self._m_gc.inc(len(deleted))
            except Exception as e:
                with self._lock:
                    self._last_error = f"gc: {type(e).__name__}: {e}"

    def _watch(self):
        while not self._stop.wait(self._poll_s):
            try:
                self._poll()
            except Exception as e:      # the watcher must never die
                self._m_errors.inc()
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"

    # ------------------------------------------------------------------
    def stats(self):
        with self._lock:
            bad = sorted(self._bad)
            last_error = self._last_error
        # counters derived from this instance's registry children
        return json_safe(
            {"served_version": self._sup.version,
             "rollouts": int(self._m_ok.value),
             "rollbacks": int(self._m_canary.value),
             "bad_versions": bad,
             "errors": int(self._m_errors.value),
             "converge_repairs": int(self._m_converge.value),
             "gc_deleted": int(self._m_gc.value),
             "last_error": last_error,
             "publish_to_served": self.publish_to_served.snapshot()})


__all__ = ["RolloutController"]
