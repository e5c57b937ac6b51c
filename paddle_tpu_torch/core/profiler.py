"""Host-side profiler: per-op/per-step spans, request trace ids and the
chrome-trace export (counterpart of paddle_tpu/core/profiler.py, ported
whole: it is pure Python).

The spans are host spans, as in the reference: ``record_event`` times a
block on the host clock when the profiler is on, and ``LatencyWindow`` is
the always-on per-request latency ring the serving stats report from.
Device time on the card comes from ``torch.profiler`` or CUDA events
(chip_smoke.py), not from here. The chrome-trace JSON has the schema of
the reference's tools/timeline.py: ph="X" complete events with
pid/tid/ts/dur, and the trace id of the request in ``args``.
"""

from __future__ import annotations

import contextvars
import json
import threading
import time
import uuid
from contextlib import contextmanager

_lock = threading.Lock()
_enabled = False
# (kind, name, t0, t1, tid, trace_id)
_events: list[tuple[str, str, float, float, int, str | None]] = []
_t_origin = 0.0
# wall-clock instant corresponding to _t_origin: per-process perf_counter
# origins are incomparable, so merged cross-process timelines
# (tools/merge_traces.py) align on this epoch anchor instead
_epoch_origin = 0.0


def _now():
    return time.perf_counter()


# ---------------------------------------------------------------------------
# distributed trace ids (the request-correlation half of the obs plane)
# ---------------------------------------------------------------------------
# A trace id is generated at a client edge (InferClient / GenClient /
# FleetClient / ParamClient — all via RpcClient), carried in the RPC
# request header, and restored server-side into this contextvar, so
# profiler spans recorded on BOTH sides of the wire carry the same id and
# tools/merge_traces.py can stitch one request into one connected track.

_TRACE_ID: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "pdtpu_trace_id", default=None)


def new_trace_id():
    """A fresh 16-hex request/trace id."""
    return uuid.uuid4().hex[:16]


def current_trace_id():
    """The trace id bound to the current context (None outside one)."""
    return _TRACE_ID.get()


def set_trace_id(trace_id):
    """Bind ``trace_id`` to the current context; returns the reset token
    (the RPC server binds the wire-carried id around each handler call)."""
    return _TRACE_ID.set(trace_id)


def reset_trace_id(token):
    _TRACE_ID.reset(token)


@contextmanager
def trace_context(trace_id=None):
    """Ensure a trace id for the block: reuse the current one, else bind
    ``trace_id`` (or a fresh id). Yields the active id — the client-edge
    entry point."""
    tid = trace_id or _TRACE_ID.get() or new_trace_id()
    token = _TRACE_ID.set(tid)
    try:
        yield tid
    finally:
        _TRACE_ID.reset(token)


def profiler_enabled():
    return _enabled


def enable_profiler(state="All"):
    """Start recording (reference EnableProfiler, profiler.h:153). ``state``
    kept for API parity — host spans are recorded either way."""
    global _enabled, _t_origin, _epoch_origin
    with _lock:
        _events.clear()
        _t_origin = _now()
        _epoch_origin = time.time()
        _enabled = True


def reset_profiler():
    with _lock:
        _events.clear()


def disable_profiler(sorted_key=None, profile_path=None):
    """Stop recording; return the aggregate table rows and optionally write a
    chrome trace (reference DisableProfiler + timeline.py)."""
    global _enabled
    with _lock:
        _enabled = False
        events = list(_events)
    if profile_path:
        export_chrome_tracing(profile_path, events)
    return summarize(events, sorted_key)


@contextmanager
def record_event(name, kind="op"):
    """RAII span (reference RecordEvent, profiler.h:98). Near-zero cost when
    profiling is off."""
    if not _enabled:
        yield
        return
    t0 = _now()
    try:
        yield
    finally:
        t1 = _now()
        with _lock:
            if _enabled:
                _events.append(
                    (kind, name, t0, t1, threading.get_ident(),
                     _TRACE_ID.get()))


def events():
    with _lock:
        return list(_events)


def summarize(evs=None, sorted_key=None):
    """Aggregate spans into per-name rows: calls, total/max/min/avg ms —
    the reference's printed profiling report (profiler.cc PrintProfiler)."""
    evs = events() if evs is None else evs
    agg: dict[str, list[float]] = {}
    for kind, name, t0, t1, _tid, *_rest in evs:
        agg.setdefault(name, []).append((t1 - t0) * 1e3)
    rows = []
    for name, durs in agg.items():
        rows.append({
            "name": name, "calls": len(durs), "total_ms": sum(durs),
            "max_ms": max(durs), "min_ms": min(durs),
            "avg_ms": sum(durs) / len(durs),
        })
    key = {None: "name", "default": "name", "calls": "calls",
           "total": "total_ms", "max": "max_ms", "min": "min_ms",
           "ave": "avg_ms", "avg": "avg_ms"}[sorted_key]
    reverse = key != "name"
    rows.sort(key=lambda r: r[key], reverse=reverse)
    return rows


def print_summary(rows, file=None):
    hdr = f"{'Event':<32}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}" \
          f"{'Max(ms)':>10}{'Ave(ms)':>10}"
    lines = ["-------------------------->  Profiling Report  "
             "<--------------------------", hdr]
    for r in rows:
        lines.append(f"{r['name']:<32}{r['calls']:>8}{r['total_ms']:>12.4f}"
                     f"{r['min_ms']:>10.4f}{r['max_ms']:>10.4f}"
                     f"{r['avg_ms']:>10.4f}")
    print("\n".join(lines), file=file)


def _percentile_sorted(vals, q):
    """q-th percentile of an already-sorted sample (linear interpolation,
    numpy's default definition — hand-rolled so this module keeps its
    stdlib-only import surface)."""
    if not vals:
        return 0.0
    if len(vals) == 1:
        return float(vals[0])
    pos = (len(vals) - 1) * (float(q) / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


def percentile(durations, q):
    """q-th percentile (0..100) by linear interpolation of the sorted
    sample — the serving stats' p50/p99 definition. Returns 0.0 on an
    empty sample so health endpoints never divide-by-zero."""
    return _percentile_sorted(sorted(durations), q)


class LatencyWindow:
    """Thread-safe sliding window of recent span durations with percentile
    readout — the always-on per-request latency tracker the model server's
    stats RPC reports from (p50/p99). Unlike the global profiler above it
    needs no enable/disable: recording into a bounded ring is cheap enough
    for every served request, and ``spans()`` feeds the same
    ``record_event`` machinery when the global profiler IS enabled, so
    serving spans still land in chrome traces."""

    def __init__(self, capacity=2048, name="span", kind="rpc"):
        self._lock = threading.Lock()
        self._cap = int(capacity)
        self._durs = []          # ring of recent durations (seconds)
        self._next = 0
        self.count = 0
        self.name = name
        self.kind = kind
        # snapshot memo keyed on (generation, count): re-reading an IDLE
        # window (SLO monitors on tight intervals, fleet scrapes over
        # hundreds of histogram children) must not re-sort the full ring
        # each time. record() bumps count; reset() bumps the generation
        # (count alone is ambiguous — a reset-then-refill can restore an
        # old count while a concurrent snapshot is mid-memoize)
        self._snap_memo = None
        self._snap_gen = 0

    def record(self, seconds):
        with self._lock:
            self.count += 1
            if len(self._durs) < self._cap:
                self._durs.append(float(seconds))
            else:
                self._durs[self._next] = float(seconds)
                self._next = (self._next + 1) % self._cap

    @contextmanager
    def span(self):
        """Time a block into the window AND the global profiler (when
        enabled) under this window's name/kind."""
        with record_event(self.name, kind=self.kind):
            t0 = _now()
            try:
                yield
            finally:
                self.record(_now() - t0)

    def percentiles(self, qs=(50, 99)):
        """{q: milliseconds} over the windowed sample (one sort)."""
        with self._lock:
            durs = sorted(self._durs)
        return {q: _percentile_sorted(durs, q) * 1e3 for q in qs}

    def snapshot(self):
        with self._lock:
            memo = self._snap_memo
            if memo is not None and memo[0] == self._snap_gen \
                    and memo[1] == self.count:
                return dict(memo[2])
            durs = sorted(self._durs)
            n = self.count
            gen = self._snap_gen
        out = {"count": n, "window": len(durs)}
        for q in (50, 99):
            out[f"p{q}_ms"] = _percentile_sorted(durs, q) * 1e3
        if durs:
            out["max_ms"] = durs[-1] * 1e3
        with self._lock:
            # only memoize the state we actually sorted: a record()
            # between the lock windows moved count on, a reset() bumped
            # the generation — either way this memo simply never hits
            if gen == self._snap_gen:
                self._snap_memo = (gen, n, dict(out))
        return out

    def reset(self):
        """Drop every sample and zero the count (test hygiene and
        forked-child registry resets — see obs.metrics)."""
        with self._lock:
            self._durs = []
            self._next = 0
            self.count = 0
            self._snap_memo = None
            self._snap_gen += 1


def export_chrome_tracing(path, evs=None):
    """Write chrome://tracing 'Complete' events (ph="X"), the exact schema of
    the reference's tools/timeline.py:40-134 _ChromeTraceFormatter."""
    evs = events() if evs is None else evs
    trace = []
    for kind, name, t0, t1, tid, *rest in evs:
        trace_id = rest[0] if rest else None
        trace.append({
            "ph": "X", "cat": kind, "name": name,
            "pid": 0, "tid": tid,
            "ts": int((t0 - _t_origin) * 1e6),
            "dur": max(1, int((t1 - t0) * 1e6)),
            "args": {} if trace_id is None else {"trace_id": trace_id},
        })
    meta = [{"ph": "M", "pid": 0, "name": "process_name",
             "args": {"name": "paddle_tpu_torch host"}}]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + trace,
                   "displayTimeUnit": "ms",
                   # wall-clock anchor of ts=0: lets merge_traces.py align
                   # files exported by DIFFERENT processes (perf_counter
                   # origins are per-process) onto one timeline
                   "otherData": {
                       "epoch_origin_us": int(_epoch_origin * 1e6)}}, f)
    return path
