"""Per-process flight recorder and incident bundles (counterpart of
paddle_tpu/obs/recorder.py, ported whole: it is pure Python).

A bounded ring of structured lifecycle events (overload and quota
rejects, model adds, evictions and reloads, ...), each stamped with the
wall clock, the active trace id (core.profiler) and a per-process
sequence number. Every :class:`~..distributed.rpc.RpcServer` answers a
built-in ``flight_dump`` method with this ring; :func:`capture_bundle`
scrapes several processes' rings into one incident bundle, and
:class:`IncidentCollector` does so on a trigger (an SLO breach, say),
keeping the last N bundles and optionally writing each as JSON into
``obs_incident_dir``. Forked children reset the ring lazily on first
touch, as obs.metrics does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..core.flags import get_flag
from ..core.profiler import current_trace_id
from .metrics import REGISTRY as _METRICS, json_safe

_M_EVENTS = _METRICS.counter(
    "paddle_tpu_flight_events",
    "flight-recorder events recorded, by event kind", labels=("kind",))
_M_INCIDENTS = _METRICS.counter(
    "paddle_tpu_flight_incidents",
    "incident bundles captured, by trigger (breach, canary_failed, "
    "child_restart, manual)", labels=("trigger",))

_FORK_EPOCH = 0


def _bump_fork_epoch():
    global _FORK_EPOCH
    _FORK_EPOCH += 1


os.register_at_fork(after_in_child=_bump_fork_epoch)


class FlightRecorder:
    """Bounded ring of structured events. ``capacity`` defaults from the
    ``obs_flight_events`` flag (read lazily at first record, so flag
    flips before any event apply). Appends are one lock + one deque
    append — cheap enough for every lifecycle decision, far too cheap to
    matter next to the RPCs and dispatches those decisions sit beside."""

    def __init__(self, capacity=None):
        self._capacity = capacity
        self._lock = threading.Lock()
        self._events = None          # created lazily (flag read)
        self._seq = 0
        self._dropped = 0
        self._epoch = _FORK_EPOCH

    def _ring_locked(self):
        if self._events is None:
            cap = self._capacity
            if cap is None:
                cap = int(get_flag("obs_flight_events"))
            self._events = deque(maxlen=max(1, int(cap)))
        return self._events

    def _check_fork(self):
        # epoch compare BEFORE touching the lock: the inherited lock may
        # be held by a parent thread that does not exist post-fork
        if self._epoch != _FORK_EPOCH:
            self._lock = threading.Lock()
            self._events = None
            self._seq = 0
            self._dropped = 0
            self._epoch = _FORK_EPOCH

    def record(self, kind, component="", **detail):
        """Append one event; returns it. ``detail`` must be small and
        JSON-safe-coercible (it crosses the flight_dump wire)."""
        self._check_fork()
        ev = {"t": time.time(), "kind": str(kind),
              "component": str(component),
              "detail": json_safe(detail) if detail else {},
              "trace": current_trace_id()}
        with self._lock:
            ring = self._ring_locked()
            if len(ring) == ring.maxlen:
                self._dropped += 1
            self._seq += 1
            ev["seq"] = self._seq
            ring.append(ev)
        _M_EVENTS.labels(kind=str(kind)).inc()
        return ev

    def events(self, kinds=None, since=None):
        """Recorded events oldest-first, optionally filtered by kind set
        and minimum wall-clock ``since``."""
        self._check_fork()
        with self._lock:
            evs = list(self._ring_locked())
        if kinds is not None:
            kinds = set(kinds)
            evs = [e for e in evs if e["kind"] in kinds]
        if since is not None:
            evs = [e for e in evs if e["t"] >= since]
        return evs

    def dump(self):
        """The ``flight_dump`` RPC payload: pid, capture instant, the
        ring (oldest first), and how many events the ring has dropped —
        already JSON-safe."""
        self._check_fork()
        with self._lock:
            evs = list(self._ring_locked())
            dropped = self._dropped
            cap = self._ring_locked().maxlen
        return {"pid": os.getpid(), "captured_at": time.time(),
                "capacity": cap, "dropped": dropped,
                "events": json_safe(evs)}

    def clear(self):
        """TEST hygiene: drop every event and reset the sequence."""
        self._check_fork()
        with self._lock:
            if self._events is not None:
                self._events.clear()
            self._seq = 0
            self._dropped = 0


RECORDER = FlightRecorder()


def record(kind, component="", **detail):
    """Record into the process-wide flight recorder (the one the
    built-in ``flight_dump`` RPC answers from)."""
    return RECORDER.record(kind, component=component, **detail)


# ---------------------------------------------------------------------------
# fleet scrape + incident bundles
# ---------------------------------------------------------------------------

def scrape_flight(addresses, timeout=2.0):
    """Scrape the built-in ``flight_dump`` RPC from each address
    CONCURRENTLY; returns ``{address: dump | None}`` (None =
    unreachable) — rides :func:`~.metrics.scrape_method`, so the
    one-timeout-for-a-dead-fleet contract is the metrics scrape's."""
    from .metrics import scrape_method
    return scrape_method(addresses, "flight_dump", timeout=timeout,
                         thread_name_prefix="obs-flight")


def capture_bundle(addresses=(), reason="manual", detail=None,
                   timeout=2.0, include_local=True):
    """One incident bundle: the local recorder plus every reachable
    endpoint's flight_dump, merged onto one (wall) clock. The bundle
    carries each event with its ``source`` (``local`` or
    ``host:port``), the sources' pids, the unreachable endpoints, and
    ``linked_traces`` — trace ids whose events span >= 2 sources, i.e.
    requests the merge can follow end to end across processes."""
    scraped = scrape_flight(addresses, timeout=timeout) if addresses \
        else {}
    processes = {}
    if include_local:
        processes["local"] = RECORDER.dump()
    for addr, dump in scraped.items():
        processes[f"{addr[0]}:{addr[1]}"] = dump
    merged = []
    trace_sources = {}
    for source, dump in processes.items():
        if dump is None:
            continue
        for ev in dump.get("events", []):
            out = dict(ev)
            out["source"] = source
            out["pid"] = dump.get("pid")
            merged.append(out)
            if ev.get("trace"):
                trace_sources.setdefault(ev["trace"], set()).add(source)
    merged.sort(key=lambda e: (e["t"], e.get("source", ""),
                               e.get("seq", 0)))
    return json_safe({
        "reason": reason,
        "detail": detail or {},
        "captured_at": time.time(),
        "local_pid": os.getpid(),
        "processes": processes,
        "unreachable": sorted(f"{a[0]}:{a[1]}"
                              for a, d in scraped.items() if d is None),
        "events": merged,
        "linked_traces": sorted(t for t, srcs in trace_sources.items()
                                if len(srcs) >= 2),
    })


def bundle_to_chrome(bundle):
    """Render an incident bundle as a chrome trace: one process lane per
    source, one instant event (``ph: "i"``) per recorder event, trace
    ids carried in args — feed the result (plus any profiler traces)
    through tools/merge_traces.py's flow-link machinery to see the
    incident as a connected timeline."""
    docs, labels = [], []
    for source, dump in (bundle.get("processes") or {}).items():
        if dump is None or not dump.get("events"):
            continue
        # anchor each doc at its earliest event and emit RELATIVE ts —
        # the same contract core.profiler chrome exports follow, so
        # merge_trace_docs shifts flight docs and profiler traces of
        # one incident onto the same clock (an absolute-ts doc with a
        # zero anchor would land ~the unix epoch away from them)
        origin = min(ev["t"] for ev in dump["events"])
        events = []
        for ev in dump["events"]:
            args = {"detail": ev.get("detail"),
                    "component": ev.get("component")}
            if ev.get("trace"):
                args["trace_id"] = ev["trace"]
            events.append({
                "ph": "i", "s": "t", "cat": "flight",
                "name": f"{ev['kind']}", "pid": 0,
                "tid": 0,
                "ts": int((ev["t"] - origin) * 1e6),
                "args": args,
            })
        docs.append({"traceEvents": events,
                     "otherData": {"epoch_origin_us": int(origin * 1e6)}})
        labels.append(f"flight:{source}")
    return docs, labels


class IncidentCollector:
    """Auto-capture incident bundles on triggers.

    ``addresses_fn`` returns the CURRENT endpoint list at capture time
    (fleets change; a static list of a supervised fleet's fixed
    addresses works too, pass ``addresses=``). ``trigger(reason)``
    returns immediately — the scrape runs on a background thread,
    cooldown-bounded (``cooldown_s``) so a crash-looping child or a
    flapping SLO can't hammer the fleet with scrapes. The last ``keep``
    bundles stay in-memory (:attr:`bundles`); when ``out_dir`` (default:
    the ``obs_incident_dir`` flag) is set, each bundle is also written
    as ``incident-<n>-<reason>.json``."""

    def __init__(self, addresses=None, addresses_fn=None, out_dir=None,
                 timeout=2.0, cooldown_s=5.0, keep=8):
        if addresses_fn is None:
            fixed = [tuple(a) for a in (addresses or [])]
            addresses_fn = lambda: fixed     # noqa: E731
        self._addresses_fn = addresses_fn
        self._out_dir = out_dir if out_dir is not None \
            else (get_flag("obs_incident_dir") or None)
        self._timeout = float(timeout)
        self._cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._last_capture_t = 0.0
        self._suppressed = 0
        self._captures = 0
        self._last_error = None
        self.bundles = deque(maxlen=int(keep))
        self._inflight = set()       # capture threads, for close()

    # ------------------------------------------------------------------
    def capture(self, reason="manual", detail=None):
        """Synchronous capture (ignores the cooldown): scrape, bundle,
        store, optionally write. Returns the bundle."""
        bundle = capture_bundle(self._addresses_fn(), reason=reason,
                                detail=detail, timeout=self._timeout)
        _M_INCIDENTS.labels(trigger=str(reason)).inc()
        with self._lock:
            self._captures += 1
            n = self._captures
            self.bundles.append(bundle)
        if self._out_dir:
            try:
                os.makedirs(self._out_dir, exist_ok=True)
                safe = "".join(c if c.isalnum() or c in "-_" else "_"
                               for c in str(reason))[:48]
                path = os.path.join(self._out_dir,
                                    f"incident-{n:04d}-{safe}.json")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(bundle, f)
                os.replace(tmp, path)
            except OSError as e:
                with self._lock:
                    self._last_error = f"write: {type(e).__name__}: {e}"
        return bundle

    def trigger(self, reason="manual", detail=None):
        """Async capture with cooldown; returns True when a capture was
        started, False when suppressed by the cooldown. The accepted
        trigger's thread runs the scrape — callers (supervisor monitor
        loops, SLO evaluations) never block on it."""
        if hasattr(reason, "as_dict") and detail is None:
            # convenience: SloMonitor(on_breach=collector.trigger)
            # passes the SloBreach finding directly
            detail = reason.as_dict()
            reason = "breach"
        now = time.monotonic()
        with self._lock:
            if now - self._last_capture_t < self._cooldown_s:
                self._suppressed += 1
                return False
            self._last_capture_t = now

        def run():
            try:
                self.capture(reason=reason, detail=detail)
            except Exception as e:
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"
            finally:
                with self._lock:
                    self._inflight.discard(threading.current_thread())

        t = threading.Thread(target=run, daemon=True,
                             name="incident-capture")
        with self._lock:
            self._inflight.add(t)
        t.start()
        return True

    def wait_idle(self, timeout=10.0):
        """Join in-flight capture threads (tests / orderly shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                threads = list(self._inflight)
            if not threads:
                return True
            threads[0].join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            return not self._inflight

    def stats(self):
        with self._lock:
            return json_safe({
                "captures": self._captures,
                "suppressed": self._suppressed,
                "bundles_held": len(self.bundles),
                "out_dir": self._out_dir,
                "last_error": self._last_error,
            })


__all__ = ["FlightRecorder", "RECORDER", "record", "scrape_flight",
           "capture_bundle", "bundle_to_chrome", "IncidentCollector"]
