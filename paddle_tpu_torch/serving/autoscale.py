"""FleetAutoscaler: close the SLO burn-rate -> replica-count loop
(counterpart of paddle_tpu/serving/autoscale.py, ported whole: it is host
code over the port's SloMonitor and FleetSupervisor).

The SLO engine produces the control signal (``paddle_tpu_slo_burn_
rate``, breach hooks) and the warm-start plane lets a spawned replica
load published ``warm/`` executables; this module is the controller that
closes the loop: a poll loop that measures, judges with the
standard :class:`~..obs.slo.SloMonitor` multi-window burn machinery
(the windows damp flapping — one hot scrape never scales anything), and
moves the fleet ONE replica per poll.

Each poll:

* scrape the fleet (``FleetSupervisor.fleet_metrics``) — one merged
  registry snapshot plus the first-class per-replica
  ``paddle_tpu_server_queue_depth`` read;
* judge the rules against the MERGED snapshot with a persistent
  monitor, so rate-reducer rules measure real deltas between polls
  (the one-shot fleet view in ``fleet_metrics`` cannot);
* any rule burning -> pre-warm the registry version
  (``registry.warm()`` is idempotent; the spawn then warm-loads) and
  ``spawn_replica`` ONE replica, canary-gated exactly like
  ``rolling_reload``: the new replica must answer health as
  serving + warmed on the fleet's current version within
  ``canary_timeout_s`` or it is retired again and the scale-out counts
  as failed — a bad scale-out must never dilute the routing set;
* no rule burning and the fleet queues empty for ``idle_polls``
  consecutive polls -> ``retire_replica`` ONE replica (down to
  ``min_replicas``);
* every breach->ok transition records an ``slo_recovered`` flight
  event, so one incident bundle shows breach, scale-out decision and
  recovery on a single timeline.
"""

from __future__ import annotations

import threading
import time

from ..core.flags import get_flag
from ..obs import recorder as _flight
from ..obs.metrics import REGISTRY as _METRICS, json_safe, next_instance
from ..obs.slo import SloMonitor, SloRule

_M_REPLICAS = _METRICS.gauge(
    "paddle_tpu_fleet_replicas",
    "current replica count of an autoscaled serving fleet, per "
    "autoscaler instance — published every poll",
    labels=("instance",))
_M_SCALE_EVENTS = _METRICS.counter(
    "paddle_tpu_fleet_scale_events",
    "FleetAutoscaler scaling actions, per instance and kind "
    "(out/in/canary_failed)",
    labels=("instance", "kind"))


class FleetAutoscaler:
    """Drive ``supervisor`` (a :class:`~.fleet.FleetSupervisor`) from
    SLO burn rate and queue depth.

    ``rules`` defaults to one queue-depth rule: the fleet-summed
    ``paddle_tpu_server_queue_depth`` judged against the
    ``serving_autoscale_queue_depth`` flag over a two-poll window. Pass
    SloRules over any fleet-visible metric (p99 latency via
    ``paddle_tpu_serving_request_seconds`` is the usual second rule).
    ``min_replicas`` / ``max_replicas`` / ``idle_polls`` default from
    the ``serving_autoscale_*`` flags; ``poll_s`` from
    ``obs_slo_interval_s``. ``registry_warm=False`` skips the
    pre-warm (tests); ``on_breach`` is handed to the monitor — wire
    ``IncidentCollector.trigger`` so every breach captures a bundle."""

    def __init__(self, supervisor, rules=None, min_replicas=None,
                 max_replicas=None, poll_s=None, idle_polls=None,
                 registry_warm=True, warm_kwargs=None,
                 canary_timeout_s=60.0, on_breach=None):
        self.supervisor = supervisor
        self.min_replicas = int(get_flag("serving_autoscale_min_replicas")
                                if min_replicas is None else min_replicas)
        self.max_replicas = int(get_flag("serving_autoscale_max_replicas")
                                if max_replicas is None else max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        self._poll_s = float(get_flag("obs_slo_interval_s")
                             if poll_s is None else poll_s)
        self._idle_polls = int(get_flag("serving_autoscale_idle_polls")
                               if idle_polls is None else idle_polls)
        self._registry_warm = bool(registry_warm)
        self._warm_kwargs = dict(warm_kwargs or {})
        self._canary_timeout_s = float(canary_timeout_s)
        self.obs_instance = next_instance("autoscaler")
        if rules is None:
            rules = [SloRule(
                "serving_fleet_queue_depth",
                metric="paddle_tpu_server_queue_depth",
                objective=float(get_flag("serving_autoscale_queue_depth")),
                reducer="value", agg="sum",
                windows=((max(2.0 * self._poll_s, 1.0), 1.0),),
                description="fleet-summed serving queue depth; burning "
                            "means arrivals are outrunning the current "
                            "replica set")]
        # a PERSISTENT monitor fed the merged fleet snapshot each poll:
        # unlike fleet_metrics' one-shot view it keeps per-rule window
        # state across polls, so rate-reducer rules measure real deltas
        self._monitor = SloMonitor(rules, interval_s=self._poll_s,
                                   on_breach=on_breach)
        self._m_replicas = _M_REPLICAS.labels(instance=self.obs_instance)
        self._m_out = _M_SCALE_EVENTS.labels(instance=self.obs_instance,
                                             kind="out")
        self._m_in = _M_SCALE_EVENTS.labels(instance=self.obs_instance,
                                            kind="in")
        self._m_canary_failed = _M_SCALE_EVENTS.labels(
            instance=self.obs_instance, kind="canary_failed")
        self._idle_streak = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._canary_failures = 0
        self._breach_active = False
        self._last_depth = None
        self._last_error = None
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------------
    def replicas(self):
        return len(self.supervisor.addresses)

    def poll_once(self):
        """One control-loop pass (also the test entry): scrape, judge,
        maybe move the fleet one replica. Returns the per-rule status."""
        fm = self.supervisor.fleet_metrics(include_local=False)
        depth = fm.get("queue_depth", {}).get("total", 0)
        self._last_depth = depth
        self._m_replicas.set(float(self.replicas()))
        status = self._monitor.evaluate_once(fm["merged"])
        burning = [name for name, s in status.items() if not s["ok"]]
        if burning:
            self._idle_streak = 0
            if not self._breach_active:
                # ok -> breach transition: with scale_out and
                # slo_recovered below, one incident bundle's local
                # recorder dump carries the whole breach -> decision ->
                # recovery arc
                _flight.record("slo_breach", component=self.obs_instance,
                               rules=list(burning), queue_depth=depth,
                               replicas=self.replicas())
            self._breach_active = True
            if self.replicas() < self.max_replicas:
                self._scale_out(burning)
        else:
            if self._breach_active:
                # breach -> ok transition: the recovery is a DECISION-
                # GRADE event — with the breach finding and the
                # scale-out below it, one incident bundle carries the
                # whole arc
                self._breach_active = False
                _flight.record("slo_recovered",
                               component=self.obs_instance,
                               replicas=self.replicas(),
                               queue_depth=depth)
            if depth == 0:
                self._idle_streak += 1
                if self._idle_streak >= self._idle_polls:
                    self._idle_streak = 0
                    if self.replicas() > self.min_replicas:
                        self._scale_in()
            else:
                self._idle_streak = 0
        self._m_replicas.set(float(self.replicas()))
        return status

    def _scale_out(self, burning):
        """ONE canary-gated replica out: pre-warm the registry version
        (idempotent — the spawn then loads executables instead of
        compiling them), spawn, health-gate; a replica that fails the
        gate is retired again, never routed to."""
        sup = self.supervisor
        version = sup.version
        if self._registry_warm:
            try:
                sup.registry.warm(sup.model, version=version,
                                  **self._warm_kwargs)
            except Exception as e:
                # pre-warm is an optimization: a failure means the spawn
                # pays its compiles, not that scale-out is off
                _flight.record("scaleout_warm_skipped",
                               component=self.obs_instance,
                               version=version,
                               error=f"{type(e).__name__}: {e}")
        _flight.record("scale_out", component=self.obs_instance,
                       rules=list(burning), version=version,
                       replicas=self.replicas() + 1)
        i, address = sup.spawn_replica(wait_timeout=None)
        deadline = time.monotonic() + self._canary_timeout_s
        try:
            sup._await_replica(i, deadline, target_version=version)
        except Exception as e:
            self._canary_failures += 1
            self._m_canary_failed.inc()
            _flight.record("scaleout_canary_failed",
                           component=self.obs_instance,
                           replica=i, address=tuple(address),
                           version=version,
                           error=f"{type(e).__name__}: {e}")
            sup.retire_replica()
            return False
        self._scale_ups += 1
        self._m_out.inc()
        return True

    def _scale_in(self):
        address = self.supervisor.retire_replica()
        self._scale_downs += 1
        self._m_in.inc()
        _flight.record("scale_in", component=self.obs_instance,
                       address=tuple(address),
                       replicas=self.replicas())
        return True

    # ------------------------------------------------------------------
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
                                        name="fleet-autoscaler")
        self._thread.start()
        return self

    def stop(self, timeout=10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def stats(self):
        return json_safe({
            "poll_s": self._poll_s,
            "replicas": self.replicas(),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "queue_depth": self._last_depth,
            "scale_ups": self._scale_ups,
            "scale_downs": self._scale_downs,
            "canary_failures": self._canary_failures,
            "idle_streak": self._idle_streak,
            "breach_active": self._breach_active,
            "rules": self._monitor.status(),
            "last_error": self._last_error,
        })


__all__ = ["FleetAutoscaler"]
