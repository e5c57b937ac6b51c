"""Process-wide metrics registry (counterpart of paddle_tpu/obs/metrics.py,
ported whole: it is pure Python).

A thread-safe process-wide :data:`REGISTRY` of named metric families
(``Counter`` / ``Gauge`` / ``Histogram``), each fanning out into labeled
children. The family names are the reference's
(``paddle_tpu_<subsystem>_<name>``), so a scrape of either package reads
the same series. Multi-instance components (engines, batchers, servers)
label their children with a process-unique ``instance`` id from
:func:`next_instance` and derive their own ``stats()`` from them.

Histograms wrap :class:`core.profiler.LatencyWindow` (a bounded ring with
p50/p99 readout), so a histogram child is also a drop-in LatencyWindow:
``.record(seconds)`` / ``.span()`` / ``.snapshot()``.

:func:`json_safe` is the wire-safety coercion every ``stats()`` and
``health()`` payload passes through: numpy scalars and arrays become
builtins, and anything else unknown (a ``torch.device``, say) its string,
so a payload crosses the RPC wire as builtins a client of either package
unpickles without importing torch.
"""

from __future__ import annotations

import itertools
import os
import re
import threading

from ..core.flags import get_flag
from ..core.profiler import LatencyWindow

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


# ---------------------------------------------------------------------------
# json coercion (the stats()/health() wire-safety helper)
# ---------------------------------------------------------------------------

def json_safe(obj):
    """Recursively coerce ``obj`` to JSON-serializable builtins: numpy
    scalars -> int/float/bool, ndarrays -> nested lists, tuples/sets ->
    lists, non-str dict keys -> builtins (numpy ints included). Used by
    every subsystem's ``stats()``/``health()`` so payloads survive
    ``json.dumps`` and the RPC wire without numpy types leaking through
    (bench ``_rec`` records ride the same helper)."""
    import numpy as np

    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(k, np.integer):
                k = int(k)
            elif not isinstance(k, (str, int, float, bool)) and k is not None:
                k = str(k)
            out[k] = json_safe(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(json_safe(v) for v in obj)
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    # exceptions, addresses, arbitrary objects: their repr is diagnosable
    return str(obj)


# ---------------------------------------------------------------------------
# instance ids
# ---------------------------------------------------------------------------

_instance_counter = itertools.count(1)


def next_instance(prefix):
    """Process-unique instance label value (``engine-3``): multi-instance
    components stamp their children with one so per-instance stats derive
    exactly and scrape series never collide."""
    return f"{prefix}-{next(_instance_counter)}"


# ---------------------------------------------------------------------------
# fork safety
# ---------------------------------------------------------------------------
# A fork-started child (pserver shards, master, reader workers) inherits
# the parent's registry: its VALUES (which the child's ``metrics`` scrape
# must not report — fleet merges would double-count them) and its LOCKS
# (which may be HELD by parent threads that do not exist in the child — a
# counter inc mid-fork — so acquiring one post-fork deadlocks). The
# after_in_child hook therefore does O(1) work only: bump the fork epoch
# and hand out fresh guard locks. Walking/zeroing the accumulated
# families eagerly in the hook stalled forked children for SECONDS on a
# loaded host (allocation bursts right after fork trigger a full GC over
# the inherited heap, COW-faulting it) — long enough for supervisors to
# declare the child wedged. Instead every family/child re-inits itself
# LAZILY on first touch by comparing its epoch BEFORE taking its lock.

_FORK_EPOCH = 0
_EPOCH_GUARD = threading.Lock()


def _bump_fork_epoch():
    global _FORK_EPOCH, _EPOCH_GUARD
    _FORK_EPOCH += 1
    _EPOCH_GUARD = threading.Lock()
    REGISTRY._lock = threading.RLock()


os.register_at_fork(after_in_child=_bump_fork_epoch)


# ---------------------------------------------------------------------------
# children
# ---------------------------------------------------------------------------

class _ScalarChild:
    """Lock + float value + fork-epoch lazy reset (counter/gauge base)."""

    __slots__ = ("_lock", "_value", "_epoch")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._epoch = _FORK_EPOCH

    def _check_fork(self):
        # epoch compare BEFORE touching self._lock: post-fork the
        # inherited lock may be held by a thread that no longer exists
        if self._epoch != _FORK_EPOCH:
            with _EPOCH_GUARD:
                if self._epoch != _FORK_EPOCH:
                    self._lock = threading.Lock()
                    self._value = 0.0
                    self._epoch = _FORK_EPOCH

    @property
    def value(self):
        self._check_fork()
        with self._lock:
            return self._value

    def _snap(self):
        v = self.value
        return {"value": int(v) if float(v).is_integer() else v}

    def _reset(self):
        self._check_fork()
        with self._lock:
            self._value = 0.0


class _CounterChild(_ScalarChild):
    """Monotonic (float) counter. ``inc`` only — a decreasing counter is
    a gauge."""

    __slots__ = ()

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self._check_fork()
        with self._lock:
            self._value += n


class _GaugeChild(_ScalarChild):
    __slots__ = ()

    def set(self, v):
        self._check_fork()
        with self._lock:
            self._value = float(v)

    def inc(self, n=1):
        self._check_fork()
        with self._lock:
            self._value += n

    def dec(self, n=1):
        self._check_fork()
        with self._lock:
            self._value -= n


class _HistogramChild:
    """A LatencyWindow-backed histogram child: ``observe``/``record``
    seconds, time a block with ``span()``, read percentiles with
    ``snapshot()`` — a drop-in replacement for the bare LatencyWindows
    the serving/online stacks used to hold directly."""

    __slots__ = ("window", "_epoch")

    def __init__(self, capacity, span_name, span_kind):
        self.window = LatencyWindow(capacity=capacity, name=span_name,
                                    kind=span_kind)
        self._epoch = _FORK_EPOCH

    def _check_fork(self):
        if self._epoch != _FORK_EPOCH:
            with _EPOCH_GUARD:
                if self._epoch != _FORK_EPOCH:
                    w = self.window
                    w._lock = threading.Lock()
                    w._durs = []
                    w._next = 0
                    w.count = 0
                    w._snap_memo = None
                    w._snap_gen += 1
                    self._epoch = _FORK_EPOCH

    def observe(self, seconds):
        self._check_fork()
        self.window.record(seconds)

    # LatencyWindow API compatibility
    record = observe

    def span(self):
        self._check_fork()
        return self.window.span()

    def percentiles(self, qs=(50, 99)):
        self._check_fork()
        return self.window.percentiles(qs)

    @property
    def count(self):
        self._check_fork()
        return self.window.count

    def snapshot(self):
        self._check_fork()
        out = self.window.snapshot()
        out.setdefault("max_ms", 0.0)
        return out

    def _snap(self):
        return self.snapshot()

    def _reset(self):
        self._check_fork()
        self.window.reset()


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------

class _Family:
    kind = None

    def __init__(self, name, help="", labels=()):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must be snake_case "
                "([a-z][a-z0-9_]*; convention: paddle_tpu_<subsystem>_<x>)")
        self.name = name
        self.help = str(help)
        self.label_names = tuple(str(l) for l in labels)
        self._lock = threading.Lock()
        self._children = {}
        self._epoch = _FORK_EPOCH

    def _check_fork(self):
        # fresh family lock post-fork (the inherited one may be held by a
        # parent thread that does not exist here); children keep their
        # identity and lazily zero themselves on their own first touch
        if self._epoch != _FORK_EPOCH:
            with _EPOCH_GUARD:
                if self._epoch != _FORK_EPOCH:
                    self._lock = threading.Lock()
                    self._epoch = _FORK_EPOCH

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        """The child for these label values (created on first use).
        Every declared label must be given; values coerce to str."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name}: labels() wants exactly "
                f"{sorted(self.label_names)}, got {sorted(kv)}")
        key = tuple(str(kv[k]) for k in self.label_names)
        self._check_fork()
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def child(self):
        """The unlabeled child (labels=() families)."""
        return self.labels()

    def children(self):
        self._check_fork()
        with self._lock:
            return dict(self._children)

    def total(self):
        """Sum of child values (counters/gauges); histogram families sum
        observation counts."""
        self._check_fork()
        with self._lock:
            kids = list(self._children.values())
        if self.kind == "histogram":
            return sum(k.count for k in kids)
        return sum(k.value for k in kids)

    def snapshot(self):
        self._check_fork()
        with self._lock:
            items = sorted(self._children.items())
        return {
            "type": self.kind,
            "help": self.help,
            "labels": list(self.label_names),
            "values": [dict(labels=dict(zip(self.label_names, key)),
                            **child._snap())
                       for key, child in items],
        }

    def reset(self):
        """Zero every child (TEST hygiene only — counters are monotonic
        for scrape consumers)."""
        self._check_fork()
        with self._lock:
            kids = list(self._children.values())
        for k in kids:
            k._reset()


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help="", labels=(), window=None,
                 span_name=None, span_kind="metric"):
        super().__init__(name, help, labels)
        self._window_cap = window
        self._span_name = span_name or name
        self._span_kind = span_kind

    def _make_child(self):
        cap = self._window_cap
        if cap is None:
            cap = int(get_flag("obs_metrics_window"))
        return _HistogramChild(cap, self._span_name, self._span_kind)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Named metric families, one process-wide instance (:data:`REGISTRY`).
    Re-registering an existing name returns the SAME family when type and
    label names agree (subsystem modules declare their families at import
    time, safely re-imported) and raises on any mismatch — two meanings
    for one name is exactly the drift this plane exists to kill."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}

    def _register(self, cls, name, help, labels, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or \
                        fam.label_names != tuple(str(l) for l in labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}; "
                        f"cannot re-register as {cls.kind} with labels "
                        f"{tuple(labels)}")
                return fam
            fam = cls(name, help, labels, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labels=()):
        return self._register(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._register(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), window=None,
                  span_name=None, span_kind="metric"):
        return self._register(Histogram, name, help, labels, window=window,
                              span_name=span_name, span_kind=span_kind)

    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def names(self):
        with self._lock:
            return sorted(self._families)

    def snapshot(self):
        """JSON-safe ``{name: family snapshot}`` — what the built-in
        ``metrics`` RPC answers and ``tools/metrics_dump.py`` renders."""
        with self._lock:
            fams = sorted(self._families.items())
        return {name: fam.snapshot() for name, fam in fams}

    def totals(self):
        """Compact ``{name: total}`` across children — the bench ``_rec``
        stamp (full snapshots are too wide for one-line JSON records)."""
        with self._lock:
            fams = sorted(self._families.items())
        out = {}
        for name, fam in fams:
            t = fam.total()
            out[name] = int(t) if float(t).is_integer() else t
        return out


REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# snapshot algebra (fleet aggregation) + export formats
# ---------------------------------------------------------------------------

def merge_snapshots(snapshots):
    """Merge registry snapshots from several processes into one fleet-wide
    view: counters and gauges SUM per (name, label set); histograms sum
    their observation counts and take the max of p99/max (percentiles do
    not merge exactly across windows — the merged view is conservative,
    per-process snapshots keep the precise numbers). ``None`` entries
    (unreachable replicas) are skipped."""
    merged = {}
    for snap in snapshots:
        if not snap:
            continue
        for name, fam in snap.items():
            dst = merged.setdefault(name, {"type": fam.get("type"),
                                           "help": fam.get("help", ""),
                                           "labels": list(
                                               fam.get("labels", [])),
                                           "values": {}})
            for v in fam.get("values", []):
                key = tuple(sorted((v.get("labels") or {}).items()))
                slot = dst["values"].get(key)
                if fam.get("type") == "histogram":
                    if slot is None:
                        dst["values"][key] = dict(v)
                    else:
                        slot["count"] = slot.get("count", 0) \
                            + v.get("count", 0)
                        slot["window"] = slot.get("window", 0) \
                            + v.get("window", 0)
                        for q in ("p50_ms", "p99_ms", "max_ms"):
                            slot[q] = max(slot.get(q, 0.0), v.get(q, 0.0))
                else:
                    if slot is None:
                        dst["values"][key] = dict(v)
                    else:
                        slot["value"] = slot.get("value", 0) \
                            + v.get("value", 0)
    for fam in merged.values():
        fam["values"] = [fam["values"][k] for k in sorted(fam["values"])]
    return merged


def _prom_escape(v):
    # exposition-format label values escape backslash, quote, newline —
    # label values can originate on the RPC wire (method names), so
    # unescaped interpolation would let a peer forge exposition lines
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _prom_label_str(labels, extra=None):
    items = list((labels or {}).items())
    if extra:
        items += list(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def prometheus_text(snapshot=None):
    """Render a registry snapshot as Prometheus text exposition: counters
    and gauges verbatim, histograms as summaries (quantile label, value in
    SECONDS) plus a ``_count`` series — what ``tools/metrics_dump.py
    --format prom`` emits."""
    if snapshot is None:
        snapshot = REGISTRY.snapshot()
    lines = []
    for name in sorted(snapshot):
        fam = snapshot[name]
        kind = fam.get("type", "counter")
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} "
                     f"{'summary' if kind == 'histogram' else kind}")
        for v in fam.get("values", []):
            labels = v.get("labels") or {}
            if kind == "histogram":
                for q, key in ((0.5, "p50_ms"), (0.99, "p99_ms")):
                    lines.append(
                        f"{name}{_prom_label_str(labels, {'quantile': q})} "
                        f"{v.get(key, 0.0) / 1e3}")
                lines.append(f"{name}_count{_prom_label_str(labels)} "
                             f"{v.get('count', 0)}")
            else:
                lines.append(
                    f"{name}{_prom_label_str(labels)} {v.get('value', 0)}")
    return "\n".join(lines) + "\n"


def scrape_method(addresses, method, timeout=2.0,
                  thread_name_prefix="obs-scrape"):
    """Call one no-arg RPC ``method`` on each address CONCURRENTLY;
    returns ``{address: payload | None}`` (None = unreachable) — a fleet
    of mid-restart children costs one ``timeout``, not one per endpoint.
    The shared engine under :func:`scrape` (``metrics``) and
    ``obs.recorder.scrape_flight`` (``flight_dump``)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..distributed.rpc import RpcClient

    def one(addr):
        c = RpcClient(addr, timeout=timeout)
        try:
            return c.call(method)
        except Exception:
            return None
        finally:
            c.close()

    addrs = [tuple(a) for a in addresses]
    if not addrs:
        return {}
    if len(addrs) == 1:
        return {addrs[0]: one(addrs[0])}
    with ThreadPoolExecutor(max_workers=min(8, len(addrs)),
                            thread_name_prefix=thread_name_prefix) as pool:
        payloads = list(pool.map(one, addrs))
    return dict(zip(addrs, payloads))


def scrape(addresses, timeout=2.0):
    """Scrape the built-in ``metrics`` RPC from each address; returns
    ``{address: snapshot | None}`` (None = unreachable) — the fleet-wide
    helper under ``FleetSupervisor.fleet_metrics`` and
    ``tools/metrics_dump.py``."""
    return scrape_method(addresses, "metrics", timeout=timeout)


__all__ = [
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "json_safe", "next_instance", "merge_snapshots", "prometheus_text",
    "scrape", "scrape_method",
]
