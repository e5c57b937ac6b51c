"""Declarative SLO rules and a background monitor (counterpart of
paddle_tpu/obs/slo.py, ported whole: it is pure Python).

* :class:`SloRule` — a rule over one metric family: a label selector, a
  reducer (``p99_ms``/``p50_ms``/``max_ms`` for histograms, ``value`` for
  gauges, ``rate``/``total`` for counters), an ``objective``, and
  multi-window burn-rate thresholds: a rule breaches only when the mean
  burn (``value / objective``) over every window exceeds that window's
  threshold. Rules are plain data (``to_dict``/``from_dict``).
* :class:`SloMonitor` — evaluates a rule set against registry snapshots
  on a background thread, sets ``paddle_tpu_slo_burn_rate{rule,
  window}``, counts breaches, keeps typed :class:`SloBreach` findings and
  fires ``on_breach``. ``ModelServer(slo_rules=...)`` builds one.
* :func:`install` / :func:`installed` / :func:`health_section` — the
  process-default monitor that ``ModelServer.health()`` reports when the
  server has none of its own.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..core.flags import get_flag
from .metrics import REGISTRY as _METRICS, json_safe

_REDUCERS = ("p99_ms", "p50_ms", "max_ms", "value", "rate", "total")

_M_BURN = _METRICS.gauge(
    "paddle_tpu_slo_burn_rate",
    "latest windowed burn rate (avg of value/objective over the window) "
    "per SLO rule and window", labels=("rule", "window"))
_M_BREACHES = _METRICS.counter(
    "paddle_tpu_slo_breaches",
    "ok->breach transitions per SLO rule (every window over threshold)",
    labels=("rule",))


class SloBreach:
    """One typed breach finding: the rule that fired, the measured value
    and objective at the transition, and the per-window burn averages
    that all exceeded their thresholds. ``as_dict()`` is the JSON-safe
    wire/health form."""

    __slots__ = ("rule", "t", "value", "objective", "burn", "windows")

    def __init__(self, rule, t, value, objective, burn, windows):
        self.rule = rule
        self.t = float(t)
        self.value = value
        self.objective = objective
        self.burn = burn              # instantaneous value/objective
        self.windows = dict(windows)  # "<seconds>s" -> avg burn

    def as_dict(self):
        return json_safe({"rule": self.rule, "t": self.t,
                          "value": self.value, "objective": self.objective,
                          "burn": self.burn, "windows": self.windows})

    def __repr__(self):
        return (f"SloBreach({self.rule!r}, value={self.value:.6g}, "
                f"objective={self.objective:.6g}, burn={self.burn:.3g})")


class SloRule:
    """One declarative objective over one metric family.

    ``reducer`` picks the number out of each matching child:
    ``p99_ms``/``p50_ms``/``max_ms`` (histogram snapshot keys),
    ``value`` (gauge/counter level), ``rate`` (counter delta per second
    between evaluations — the queue-growth / error-rate form), or
    ``total`` (alias of ``value``). ``labels`` filters children (every
    given label must match; omitted labels match anything). ``agg``
    folds multiple matching children: ``max`` (default — the worst
    instance is the one that pages) or ``sum``. ``windows`` is a tuple
    of ``(window_seconds, burn_threshold)`` pairs; the rule breaches
    when EVERY window's average burn meets its threshold."""

    __slots__ = ("name", "metric", "objective", "reducer", "labels",
                 "agg", "windows", "description")

    def __init__(self, name, metric, objective, reducer="p99_ms",
                 labels=None, agg="max", windows=((5.0, 1.0), (60.0, 1.0)),
                 description=""):
        self.name = str(name)
        self.metric = str(metric)
        self.objective = float(objective)
        self.reducer = str(reducer)
        self.labels = {str(k): str(v) for k, v in (labels or {}).items()}
        self.agg = str(agg)
        self.windows = tuple((float(w), float(th)) for w, th in windows)
        self.description = str(description)
        if self.objective <= 0:
            raise ValueError(
                f"SLO rule {self.name!r}: objective must be > 0 "
                f"(got {self.objective}) — burn rate is value/objective")
        if self.reducer not in _REDUCERS:
            raise ValueError(
                f"SLO rule {self.name!r}: reducer must be one of "
                f"{_REDUCERS}, got {self.reducer!r}")
        if self.agg not in ("max", "sum"):
            raise ValueError(
                f"SLO rule {self.name!r}: agg must be 'max' or 'sum', "
                f"got {self.agg!r}")
        if not self.windows:
            raise ValueError(f"SLO rule {self.name!r}: needs at least "
                             "one (window_s, burn_threshold) pair")
        for w, _th in self.windows:
            if w <= 0:
                raise ValueError(f"SLO rule {self.name!r}: window "
                                 f"seconds must be > 0, got {w}")

    # rules cross process boundaries as plain dicts (spawned replica
    # children rebuild their monitor from the child config)
    def to_dict(self):
        return {"name": self.name, "metric": self.metric,
                "objective": self.objective, "reducer": self.reducer,
                "labels": dict(self.labels), "agg": self.agg,
                "windows": [list(w) for w in self.windows],
                "description": self.description}

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        unknown = set(d) - {"name", "metric", "objective", "reducer",
                            "labels", "agg", "windows", "description"}
        if unknown:
            raise ValueError(f"SLO rule dict has unknown fields "
                             f"{sorted(unknown)}")
        return cls(**d)

    # ------------------------------------------------------------------
    def measure(self, snapshot):
        """Reduce one registry snapshot to this rule's measured value —
        None when the family (or any matching child) is absent, which
        evaluates as burn 0 (an unobserved signal is not a breach)."""
        fam = (snapshot or {}).get(self.metric)
        if fam is None:
            return None
        vals = []
        for child in fam.get("values", []):
            labels = child.get("labels") or {}
            if any(labels.get(k) != v for k, v in self.labels.items()):
                continue
            if self.reducer in ("value", "total", "rate"):
                v = child.get("value")
            else:
                v = child.get(self.reducer)
            if v is not None:
                vals.append(float(v))
        if not vals:
            return None
        return max(vals) if self.agg == "max" else sum(vals)


class _RuleState:
    """Per-rule evaluation state (owned by one monitor): the burn-sample
    ring per window, the last counter level (for ``rate``), and the
    current ok/breach flag."""

    __slots__ = ("rule", "samples", "last_level", "last_t", "breached",
                 "last_value", "last_burn", "last_window_burn",
                 "breach_total", "m_burn", "m_breaches")

    def __init__(self, rule, emit_metrics=True):
        self.rule = rule
        # (t, burn) samples covering the longest window; the deque bound
        # is a backstop — trimming is by timestamp
        self.samples = deque(maxlen=65536)
        self.last_level = None
        self.last_t = None
        self.breached = False
        self.last_value = None
        self.last_burn = 0.0
        self.last_window_burn = {}
        self.breach_total = 0
        # registry children only for EMITTING monitors — a one-shot
        # fleet-view evaluation must not write the background monitor's
        # paddle_tpu_slo_* series
        self.m_burn = {f"{w:g}s": _M_BURN.labels(rule=rule.name,
                                                 window=f"{w:g}s")
                       for w, _th in rule.windows} if emit_metrics else {}
        self.m_breaches = _M_BREACHES.labels(rule=rule.name) \
            if emit_metrics else None


class SloMonitor:
    """Evaluate ``rules`` every ``interval_s`` (default the
    ``obs_slo_interval_s`` flag) against ``snapshot_fn()`` (default the
    local registry). ``on_breach(finding)`` fires on each ok->breach
    transition — the incident hook."""

    def __init__(self, rules, snapshot_fn=None, interval_s=None,
                 on_breach=None, max_findings=256, emit_metrics=True):
        self.rules = [r if isinstance(r, SloRule) else SloRule.from_dict(r)
                      for r in rules]
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names: {sorted(names)}")
        self._snapshot_fn = snapshot_fn or self._rule_families_snapshot
        self.interval_s = float(get_flag("obs_slo_interval_s")
                                if interval_s is None else interval_s)
        self._on_breach = on_breach
        self._lock = threading.Lock()
        self._states = {r.name: _RuleState(r, emit_metrics=emit_metrics)
                        for r in self.rules}
        self._findings = deque(maxlen=int(max_findings))
        self._evaluations = 0
        self._last_error = None
        self._stop = threading.Event()
        self._thread = None

    def _rule_families_snapshot(self):
        """Default snapshot source: ONLY the metric families the rules
        reference, resolved live from the local registry. A full
        ``REGISTRY.snapshot()`` serializes every family — including
        every histogram child's percentile sort — and its cost grows
        with the whole process's series count; a monitor judging two
        rules on a tight interval was paying for all of it (measured
        several ms per pass in a bench-sized registry, real GIL steal
        on small hosts). Pass ``snapshot_fn=`` for fleet views or full
        snapshots."""
        out = {}
        for name in {r.metric for r in self.rules}:
            fam = _METRICS.get(name)
            if fam is not None:
                out[name] = fam.snapshot()
        return out

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("SloMonitor already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="slo-monitor")
        self._thread.start()
        return self

    def stop(self, timeout=10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def _watch(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception as e:       # the monitor must never die
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"

    # ------------------------------------------------------------------
    def evaluate_once(self, snapshot=None, now=None):
        """One evaluation pass (also the one-shot fleet-view entry:
        ``monitor.evaluate_once(merge_snapshots(...))``). Returns the
        per-rule status dict."""
        if snapshot is None:
            snapshot = self._snapshot_fn()
        now = time.monotonic() if now is None else float(now)
        new_findings = []
        with self._lock:
            self._evaluations += 1
            for st in self._states.values():
                self._evaluate_rule_locked(st, snapshot, now, new_findings)
            status = self._status_locked()
        # callbacks OUTSIDE the lock: an incident capture scrapes the
        # fleet and must not serialize against evaluations
        if self._on_breach is not None:
            for f in new_findings:
                try:
                    self._on_breach(f)
                except Exception:
                    pass
        return status

    def _evaluate_rule_locked(self, st, snapshot, now, new_findings):
        rule = st.rule
        value = rule.measure(snapshot)
        if rule.reducer == "rate":
            level, value = value, None
            if level is not None and st.last_level is not None \
                    and st.last_t is not None and now > st.last_t:
                value = max(0.0, level - st.last_level) / (now - st.last_t)
            if level is not None:
                st.last_level = level
        st.last_t = now
        burn = 0.0 if value is None else value / rule.objective
        st.last_value = value
        st.last_burn = burn
        st.samples.append((now, burn))
        horizon = max(w for w, _th in rule.windows)
        while st.samples and st.samples[0][0] < now - horizon:
            st.samples.popleft()
        over_all = True
        window_burn = {}
        for w, th in rule.windows:
            in_win = [b for t, b in st.samples if t >= now - w]
            avg = sum(in_win) / len(in_win) if in_win else 0.0
            key = f"{w:g}s"
            window_burn[key] = avg
            if st.m_burn:
                st.m_burn[key].set(avg)
            if avg < th:
                over_all = False
        st.last_window_burn = window_burn
        if over_all and not st.breached:
            st.breached = True
            st.breach_total += 1
            if st.m_breaches is not None:
                st.m_breaches.inc()
            finding = SloBreach(rule.name, time.time(), value,
                                rule.objective, burn, window_burn)
            self._findings.append(finding)
            new_findings.append(finding)
        elif not over_all:
            st.breached = False

    # ------------------------------------------------------------------
    def _status_locked(self):
        out = {}
        for name, st in self._states.items():
            out[name] = {
                "ok": not st.breached,
                "value": st.last_value,
                "objective": st.rule.objective,
                "burn": st.last_burn,
                "windows": dict(st.last_window_burn),
                "breaches": st.breach_total,
            }
        return json_safe(out)

    def status(self):
        """{rule: {ok, value, objective, burn, windows, breaches}} —
        the per-rule verdict surface."""
        with self._lock:
            return self._status_locked()

    def findings(self, clear=False):
        """Typed breach findings (newest last, bounded)."""
        with self._lock:
            out = list(self._findings)
            if clear:
                self._findings.clear()
        return out

    def breach_count(self):
        with self._lock:
            return sum(st.breach_total for st in self._states.values())

    def health_section(self):
        """The JSON-safe dict health()/stats() surfaces embed: overall
        ok flag, per-rule status, recent findings."""
        with self._lock:
            status = self._status_locked()
            findings = [f.as_dict() for f in list(self._findings)[-8:]]
            evals = self._evaluations
            err = self._last_error
        return json_safe({
            "ok": all(s["ok"] for s in status.values()),
            "running": self.running(),
            "evaluations": evals,
            "rules": status,
            "recent_breaches": findings,
            "last_error": err,
        })

    # ------------------------------------------------------------------
    def install(self):
        """Make this monitor the process default (what health()/stats()
        surfaces report). Returns self."""
        install(self)
        return self


# ---------------------------------------------------------------------------
# process-default monitor
# ---------------------------------------------------------------------------

_INSTALL_LOCK = threading.Lock()
_INSTALLED = None


def install(monitor):
    """Set (or clear, with None) the process-default SloMonitor."""
    global _INSTALLED
    with _INSTALL_LOCK:
        _INSTALLED = monitor
    return monitor


def installed():
    """The process-default SloMonitor, or None."""
    return _INSTALLED


def health_section():
    """The installed monitor's health section, or None when no monitor
    is installed — the one-liner every health()/stats() surface calls."""
    m = _INSTALLED
    return m.health_section() if m is not None else None


__all__ = ["SloRule", "SloBreach", "SloMonitor", "install", "installed",
           "health_section"]
