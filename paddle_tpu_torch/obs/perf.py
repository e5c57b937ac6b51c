"""Performance introspection plane (counterpart of paddle_tpu/obs/perf.py):
compile telemetry, device-memory watermarks, cost attribution and device
traces.

* **Compile telemetry** — :func:`note_compile` lands one build in
  ``paddle_tpu_compile_seconds{site}``, a :class:`CompileRecord` in the
  bounded per-process :data:`COMPILE_LOG` and a ``compile`` flight-recorder
  event carrying the active trace id, as the reference's does. PyTorch runs
  eagerly, so the port's "compiles" are the events its engines already
  count as compiles (``serving/engine.py``): the first dispatch of a
  (bucket, signature) (sites ``engine_warmup`` / ``engine_infer``,
  ``genengine_warmup`` / ``genengine_<phase>``), a ``torch.export`` trace
  (``aot_export``, ``exec_cache_save``), an artifact load (``aot_load``,
  ``exec_cache_load``) and an ``nvcc`` build of a kernel library
  (``nvcc_build``, ``ops/cuda/build.py``). :func:`compile_site` /
  :func:`current_site` label a build with its caller's site, as in the
  reference. The ``obs_compile_log`` flag (capacity; 0 disables) turns the
  layer off.
* **Device-memory watermarks** — :func:`sample_device_memory` sets
  ``paddle_tpu_device_bytes_live{device}`` and, where the source reports
  one, ``paddle_tpu_device_bytes_peak{device}``. The sources are
  measurements, named per device in the sample: ``cuda_allocator`` (on
  each card this process has initialised, ``torch.cuda.memory_allocated``
  and ``max_memory_allocated``; the reference reads the backend's
  ``memory_stats`` or walks ``jax.live_arrays()``) and, where no card is
  in use, ``process_rss`` (the resident set from ``/proc/self/statm`` and
  ``getrusage``'s peak: host bytes, where a CPU run's tensors live).
  :class:`MemorySampler` re-samples on the ``obs_slo_interval_s`` cadence,
  self-bounding its cost as the reference's does.
* **Cost attribution** — :func:`attribute` runs ONE dispatch of a
  Program, a bundle directory or an ``InferenceEngine`` through the
  Executor's own op loop with each op under
  ``torch.utils.flop_counter.FlopCounterMode`` (the kernels' operators
  register their FLOP formulas: ``ops/cuda/conv_bn.py``) and a tally of
  each op's operand and result bytes, and returns the reference's dict
  shape (``cost``, ``kind_totals``, ``rows``, ``instructions``,
  ``compile_seconds``; ``per_op=True`` adds the ``{op, kind, flops,
  bytes, shape}`` rows the placement planner reads). A row is a Program
  op, not an HLO instruction: the port has no HLO text, so the
  reference's ``hlo_shape_bytes`` / ``hlo_entry_rows`` / ``per_op_rows`` /
  ``lower_program`` / ``cost_totals`` / ``harvest_cost`` and
  ``attribute(dump_hlo=)`` have no counterpart (ROADMAP §C).
* **Device traces** — :func:`profile` runs any step callable under
  ``torch.profiler`` and aggregates the CUDA kernel events by name. It
  also reports the kernel wrappers' launch counts over the traced steps
  (``ops.cuda.launch_counts``) beside the events of those kernels it saw:
  torch.profiler can drop records after earlier sessions in one process,
  and a short trace must not pass silently.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager

from ..core.flags import get_flag
from .metrics import REGISTRY as _METRICS, json_safe

_M_COMPILE_SECONDS = _METRICS.histogram(
    "paddle_tpu_compile_seconds",
    "wall seconds per build (a signature's first eager dispatch, a "
    "torch.export trace, an artifact load, an nvcc kernel build), "
    "labeled by compile site",
    labels=("site",), span_name="perf/compile", span_kind="stage")
_M_BYTES_LIVE = _METRICS.gauge(
    "paddle_tpu_device_bytes_live",
    "live memory bytes per device — the CUDA caching allocator's "
    "memory_allocated on a card, else the process's resident set",
    labels=("device",))
_M_BYTES_PEAK = _METRICS.gauge(
    "paddle_tpu_device_bytes_peak",
    "peak memory bytes per device — max_memory_allocated on a card, else "
    "the process's peak resident set",
    labels=("device",))

_FORK_EPOCH = 0


def _bump_fork_epoch():
    global _FORK_EPOCH
    _FORK_EPOCH += 1


os.register_at_fork(after_in_child=_bump_fork_epoch)


# ---------------------------------------------------------------------------
# compile telemetry
# ---------------------------------------------------------------------------

def enabled():
    """Whether the compile-telemetry layer records anything (the
    ``obs_compile_log`` capacity flag is > 0)."""
    return int(get_flag("obs_compile_log")) > 0


class CompileRecord:
    """One build: where it happened (``site``), what it cost (``seconds``
    wall), which executable (``identity``: bucket / phase / kernel /
    artifact tag, site-dependent; engines with a warm-executable cache
    stamp ``cache_hit``) and, where counted, its ``flops`` /
    ``bytes_accessed`` (None otherwise)."""

    __slots__ = ("site", "seconds", "t", "identity", "flops",
                 "bytes_accessed", "trace", "seq")

    def __init__(self, site, seconds, identity=None, flops=None,
                 bytes_accessed=None, trace=None):
        self.site = str(site)
        self.seconds = float(seconds)
        self.t = time.time()
        self.identity = json_safe(identity or {})
        self.flops = None if flops is None else float(flops)
        self.bytes_accessed = None if bytes_accessed is None \
            else float(bytes_accessed)
        self.trace = trace
        self.seq = 0

    def as_dict(self):
        return json_safe({
            "site": self.site, "seconds": self.seconds, "t": self.t,
            "identity": self.identity, "flops": self.flops,
            "bytes_accessed": self.bytes_accessed, "trace": self.trace,
            "seq": self.seq,
        })

    def __repr__(self):
        return (f"CompileRecord({self.site!r}, {self.seconds:.3f}s, "
                f"identity={self.identity})")


class CompileLog:
    """Bounded per-process ring of :class:`CompileRecord`. Capacity
    defaults from the ``obs_compile_log`` flag (read lazily at first
    record); forked children reset lazily, as obs.recorder's ring does."""

    def __init__(self, capacity=None):
        self._capacity = capacity
        self._lock = threading.Lock()
        self._records = None
        self._seq = 0
        self._total_seconds = 0.0
        self._epoch = _FORK_EPOCH

    def _check_fork(self):
        if self._epoch != _FORK_EPOCH:
            self._lock = threading.Lock()
            self._records = None
            self._seq = 0
            self._total_seconds = 0.0
            self._epoch = _FORK_EPOCH

    def _ring_locked(self):
        if self._records is None:
            cap = self._capacity
            if cap is None:
                cap = int(get_flag("obs_compile_log"))
            self._records = deque(maxlen=max(1, int(cap)))
        return self._records

    def add(self, record):
        self._check_fork()
        with self._lock:
            self._seq += 1
            record.seq = self._seq
            self._total_seconds += record.seconds
            self._ring_locked().append(record)
        return record

    def records(self, site=None):
        """Records oldest-first (the ring's window), optionally filtered
        to one site."""
        self._check_fork()
        with self._lock:
            recs = list(self._ring_locked())
        if site is not None:
            recs = [r for r in recs if r.site == site]
        return recs

    def stats(self):
        """``{count, total_seconds, by_site}`` — count/total cover the
        process lifetime (not just the ring window)."""
        self._check_fork()
        with self._lock:
            recs = list(self._ring_locked())
            count, total = self._seq, self._total_seconds
        by_site = {}
        for r in recs:
            s = by_site.setdefault(r.site, {"count": 0, "seconds": 0.0})
            s["count"] += 1
            s["seconds"] += r.seconds
        return json_safe({"count": count, "total_seconds": total,
                          "by_site": by_site})

    def clear(self):
        """Drop every record and reset the counters."""
        self._check_fork()
        with self._lock:
            if self._records is not None:
                self._records.clear()
            self._seq = 0
            self._total_seconds = 0.0


COMPILE_LOG = CompileLog()

_SITE = threading.local()


@contextmanager
def compile_site(site, **detail):
    """Label any build noted inside the block with ``site`` (a bounded
    code-site name: it becomes a metric label value) and attach
    ``detail`` to its CompileRecord identity."""
    prev = getattr(_SITE, "value", None)
    _SITE.value = (str(site), detail)
    try:
        yield
    finally:
        _SITE.value = prev


def current_site(default="jit_step"):
    """(site, detail) the next noted build should be attributed to."""
    v = getattr(_SITE, "value", None)
    if v is None:
        return default, {}
    return v


def note_compile(site, seconds, identity=None, flops=None,
                 bytes_accessed=None):
    """Land one build in the telemetry layer: a histogram observation
    (labeled by site), a CompileRecord in :data:`COMPILE_LOG`, and a
    ``compile`` flight-recorder event carrying the active trace id. No-op
    when the layer is off."""
    if not enabled():
        return None
    rec = CompileRecord(site, seconds, identity=identity, flops=flops,
                        bytes_accessed=bytes_accessed)
    from .recorder import record as _flight_record
    _M_COMPILE_SECONDS.labels(site=rec.site).observe(rec.seconds)
    ev = _flight_record("compile", component=rec.site,
                        seconds=round(rec.seconds, 4),
                        **{k: v for k, v in rec.identity.items()
                           if k in ("bucket", "phase", "instance",
                                    "program_version", "cache_hit",
                                    "kernel", "tag")})
    rec.trace = ev.get("trace")
    COMPILE_LOG.add(rec)
    return rec


# ---------------------------------------------------------------------------
# device-memory watermarks
# ---------------------------------------------------------------------------

def _cuda_devices():
    """Indices of the cards this process has initialised (none when torch
    is not imported or CUDA was never touched: sampling must not create a
    CUDA context)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() \
            or not torch.cuda.is_initialized():
        return torch, []
    return torch, list(range(torch.cuda.device_count()))


def _process_rss():
    """(resident bytes, peak resident bytes), either None where it cannot
    be read."""
    live = peak = None
    try:
        with open("/proc/self/statm") as f:
            live = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        # ru_maxrss is in KiB on Linux
        peak = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except (ImportError, OSError, ValueError):
        pass
    return live, peak


def sample_device_memory():
    """One memory sample. Returns ``{"devices": {label: bytes}, "peaks":
    {...}, "sources": {label: "cuda_allocator"|"process_rss"}, "total":
    int}`` and sets the gauges."""
    devices, peaks, sources = {}, {}, {}
    torch, cards = _cuda_devices()
    for i in cards:
        label = f"cuda:{i}"
        devices[label] = int(torch.cuda.memory_allocated(i))
        peaks[label] = int(torch.cuda.max_memory_allocated(i))
        sources[label] = "cuda_allocator"
    if not cards:
        live, peak = _process_rss()
        if live is not None:
            devices["cpu:0"] = live
            sources["cpu:0"] = "process_rss"
            if peak is not None:
                # the two are read at different instants: the peak is at
                # least the resident set just measured
                peaks["cpu:0"] = max(peak, live)
    for label, b in devices.items():
        _M_BYTES_LIVE.labels(device=label).set(b)
    for label, b in peaks.items():
        _M_BYTES_PEAK.labels(device=label).set(b)
    return {"devices": devices, "peaks": peaks, "sources": sources,
            "total": sum(devices.values())}


def memory_section():
    """The JSON-safe dict ``health()``/``stats()`` surfaces embed — one
    fresh sample (so a health scrape always carries a current gauge)."""
    s = sample_device_memory()
    return json_safe({
        "device_bytes_live": s["devices"],
        "device_bytes_peak": s["peaks"],
        "sources": s["sources"],
        "total_bytes_live": s["total"],
    })



class MemorySampler:
    """Background device-memory sampler: re-samples every ``interval_s``
    (default: the ``obs_slo_interval_s`` flag), keeping the
    ``paddle_tpu_device_bytes_live`` gauge fresh for SLO rules and
    scrapes without a caller in the loop. Self-bounding as the
    reference's: after each sample the wait stretches to at least
    ``cost_factor`` times the sample's duration, so a sampler never takes
    more than ~1/cost_factor of a core (``effective_interval_s`` in
    :meth:`stats` reports the stretch)."""

    def __init__(self, interval_s=None, cost_factor=50.0):
        self.interval_s = float(get_flag("obs_slo_interval_s")
                                if interval_s is None else interval_s)
        self.cost_factor = float(cost_factor)
        self._stop = threading.Event()
        self._thread = None
        self._samples = 0
        self._last_error = None
        self._effective_interval_s = self.interval_s

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("MemorySampler already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="perf-memory-sampler")
        self._thread.start()
        return self

    def _watch(self):
        while not self._stop.wait(self._effective_interval_s):
            try:
                self.sample_now()
            except Exception as e:     # the sampler must never die
                self._last_error = f"{type(e).__name__}: {e}"

    def sample_now(self):
        """One synchronous sample on the calling thread; counts like a
        background sample and primes the cost-bounded cadence."""
        t0 = time.perf_counter()
        out = sample_device_memory()
        dt = time.perf_counter() - t0
        self._samples += 1
        self._effective_interval_s = max(self.interval_s,
                                         dt * self.cost_factor)
        return out

    def stop(self, timeout=10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True

    def running(self):
        return self._thread is not None and self._thread.is_alive()

    @property
    def samples(self):
        return self._samples

    def stats(self):
        return json_safe({"running": self.running(),
                          "interval_s": self.interval_s,
                          "effective_interval_s": self._effective_interval_s,
                          "samples": self._samples,
                          "last_error": self._last_error})


# ---------------------------------------------------------------------------
# cost attribution (one dispatch through the op loop, FLOPs and bytes)
# ---------------------------------------------------------------------------

def template_feed(program, feed_names, batch=1):
    """Zero feed synthesized from the program's feed-var metadata (shape
    ``[-1, d1, ...]`` + dtype) at ``batch`` rows."""
    import numpy as np

    block = program.global_block()
    feed = {}
    for name in feed_names:
        v = block.var(name)
        dims = list(v.shape or [])
        if dims and dims[0] == -1:
            dims = dims[1:]
        if any(d is None or int(d) < 0 for d in dims):
            raise ValueError(
                f"feed var {name!r} has unknown dims {v.shape}; pass an "
                "explicit feed")
        dt = "float32" if v.dtype in (None, "bfloat16") else str(v.dtype)
        feed[name] = np.zeros([int(batch)] + [int(d) for d in dims],
                              np.dtype(dt))
    return feed


def _nbytes(v):
    """Bytes of a tensor, a LoDArray's data and lengths, or a SparseRows'
    rows and values; 0 for anything else."""
    import torch
    if isinstance(v, torch.Tensor):
        return int(v.numel()) * int(v.element_size())
    total = 0
    for attr in ("data", "lens", "rows", "values"):
        t = getattr(v, attr, None)
        if isinstance(t, torch.Tensor):
            total += int(t.numel()) * int(t.element_size())
    return total


def _shape(v):
    t = getattr(v, "data", v)
    shape = getattr(t, "shape", None)
    return None if shape is None else [int(d) for d in shape]


def _op_loop_rows(program, feed, fetch_names, executor, scope):
    """Run one dispatch of ``program`` through the Executor's op loop,
    each op under its own FlopCounterMode, and return (rows, seconds):
    one ``{op, kind, flops, bytes, shape}`` row per op in program order,
    ``bytes`` its operands' and results' bytes as they lie in the op loop's
    environment, ``shape`` its first result's."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..core import registry
    from ..core.amp import amp_guard
    from ..core.executor import _RNG_KEY, _analyze_program, _run_ops

    block = program.global_block()
    feed_vals = executor._prepare_feed(block, dict(feed))
    executor._seed_scope(program, scope)
    analysis = _analyze_program(program)
    env = {n: scope.find_var(n) for n in analysis.free
           if n not in feed_vals and scope.has_var(n)}
    env.update(feed_vals)
    env[_RNG_KEY] = scope.find_var(_RNG_KEY)
    rows = []

    def counted(i, op):
        fwd = registry.get_op_info(op.type).forward

        def run(ctx):
            in_b = sum(_nbytes(env.get(n)) for n in op.input_arg_names())
            with FlopCounterMode(display=False) as fc:
                fwd(ctx)
            outs = op.output_arg_names()
            out_b = sum(_nbytes(env.get(n)) for n in outs)
            rows.append({"op": f"{op.type}_{i}", "kind": op.type,
                         "flops": float(fc.get_total_flops()),
                         "bytes": in_b + out_b,
                         "shape": _shape(env.get(outs[0])) if outs
                         else None})
        return run

    override = [counted(i, op) for i, op in enumerate(block.ops)]
    t0 = time.perf_counter()
    with torch.no_grad(), amp_guard(executor.amp):
        _run_ops(block, env, executor.device, override=override)
        for n in fetch_names:
            env[n]   # a fetch the program never wrote raises here
    if executor.device.type == "cuda":
        torch.cuda.synchronize(executor.device)
    return rows, time.perf_counter() - t0


def attribute(target, feed=None, fetch_list=None, batch=1, top=40,
              executor=None, scope=None, per_op=False):
    """Per-op cost attribution of ONE dispatch. ``target`` is a
    ``Program`` (with ``feed`` + ``fetch_list``), a bundle directory
    (loaded into a private scope on the executor's device, the card
    unless ``executor`` says otherwise; feeds synthesized at ``batch``
    rows), or an ``InferenceEngine`` (its program, scope and executor).

    Returns the reference's dict shape: ``{"cost": {flops,
    bytes_accessed, detail}, "kind_totals": {op type: bytes}, "rows":
    [{bytes, result_bytes, kind, name, hlo}] (the top-N by bytes; ``hlo``
    holds the op's result shape, the port having no HLO text),
    "instructions": ops run, "compile_seconds": the dispatch's wall
    seconds}``. FLOPs are FlopCounterMode's count (a multiply-add is two)
    over the op loop, the kernels' operators by their registered
    formulas. ``per_op=True`` adds ``"per_op"``: every op as ``{op, kind,
    flops, bytes, shape}``."""
    from ..serving.engine import InferenceEngine

    if isinstance(target, str):
        from ..core.executor import Executor
        from ..core.scope import Scope
        from ..fluid import io as fluid_io
        scope = scope if scope is not None else Scope()
        exe = executor or Executor()
        program, feed_names, fetch_vars = fluid_io.load_inference_model(
            target, exe, scope=scope)
        feed = feed if feed is not None \
            else template_feed(program, feed_names, batch=batch)
        fetch_list = fetch_vars if fetch_list is None else fetch_list
        executor = exe
    elif isinstance(target, InferenceEngine):
        program = target.program
        scope = target._scope if scope is None else scope
        executor = target._exe if executor is None else executor
        feed = feed if feed is not None \
            else template_feed(program, target.feed_names, batch=batch)
        fetch_list = target.fetch_names if fetch_list is None else fetch_list
    else:
        program = target
        if feed is None or fetch_list is None:
            raise ValueError(
                "attribute(program, ...) needs feed= and fetch_list= "
                "(bundle dirs and engines synthesize their own)")
        if executor is None:
            from ..core.executor import Executor
            executor = Executor()
        if scope is None:
            from ..core.scope import global_scope
            scope = global_scope()
    fetch_names = [f if isinstance(f, str) else f.name for f in fetch_list]
    rows, seconds = _op_loop_rows(program, feed, fetch_names, executor,
                                  scope)
    total_flops = sum(r["flops"] for r in rows)
    total_bytes = sum(r["bytes"] for r in rows)
    kind_totals = {}
    for r in rows:
        kind_totals[r["kind"]] = kind_totals.get(r["kind"], 0) + r["bytes"]
    note_compile("attribute", seconds,
                 identity={"fetch": fetch_names[:4]}, flops=total_flops,
                 bytes_accessed=total_bytes)
    ranked = sorted(rows, key=lambda r: -r["bytes"])
    out = {
        "cost": {"flops": total_flops, "bytes_accessed": total_bytes,
                 "detail": {}},
        "kind_totals": dict(sorted(kind_totals.items(),
                                   key=lambda kv: -kv[1])),
        "rows": [{"bytes": r["bytes"], "result_bytes": None,
                  "kind": r["kind"], "name": r["op"],
                  "hlo": str(r["shape"])}
                 for r in ranked[:int(top)]],
        "instructions": len(rows),
        "compile_seconds": seconds,
    }
    if per_op:
        out["per_op"] = rows
    return json_safe(out)


# ---------------------------------------------------------------------------
# device traces (torch.profiler, kernel events by name)
# ---------------------------------------------------------------------------

def _sync():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# each wrapper's launch as the device kernel that marks it (one a launch)
_MARK_KERNEL = {
    "conv_affine": "conv_affine_kernel",
    "conv_affine_db": "conv_affine_kernel",
    "conv_bn_train": "conv_stats_kernel",
    "conv_bn_train_db": "conv_stats_kernel",
    "conv_bn_bwd": "grad_finalize_kernel", "sgd_arena": "sgd_arena_kernel",
    "momentum_arena": "momentum_arena_kernel",
    "adam_arena": "adam_arena_kernel", "lstm_seq": "lstm_fwd_kernel",
    "lstm_seq_bwd": "lstm_bwd_kernel", "gru_seq": "gru_fwd_kernel",
    "gru_seq_bwd": "gru_bwd_kernel", "ctc_alpha": "ctc_fwd_kernel",
    "ctc_loss_bwd": "ctc_bwd_kernel",
    "paged_attention": "paged_attention_kernel",
    "embedding_sgd": "embedding_sgd",
}


def profile(fn, steps=8, warmup=2, trace_dir=None, top=40):
    """Per-kernel device timing of ANY step callable: ``warmup`` untraced
    calls, then ``steps`` under ``torch.profiler``, the CUDA kernel events
    aggregated by name (the CPU's operator events where no card is in use
    — ``on_device`` says which). ``trace_dir`` also writes the chrome
    trace there.

    Returns ``{"steps", "wall_s_per_step", "on_device",
    "busy_us_per_step", "by_kind", "top", "launches", "kernel_events",
    "complete"}``: ``launches`` is the kernel wrappers' launch counts over
    the traced steps (``ops.cuda.launch_counts``), ``kernel_events`` the
    trace's events of those kernels by wrapper, and ``complete`` whether
    the trace holds at least one event for every launch (False flags a
    trace the profiler cut short)."""
    import torch
    from torch.profiler import ProfilerActivity

    from ..ops.cuda import launch_counts

    for _ in range(int(warmup)):
        fn()
    _sync()
    acts = [ProfilerActivity.CPU]
    on_device = torch.cuda.is_available() and torch.cuda.is_initialized()
    if on_device:
        acts.append(ProfilerActivity.CUDA)
    before = launch_counts()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(int(steps)):
            fn()
        _sync()
    wall = time.perf_counter() - t0
    after = launch_counts()
    launched = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    launched = {k: v for k, v in launched.items() if v}
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    per_name, per_name_n = {}, {}
    for e in prof.events():
        dev = getattr(e, "device_type", None)
        is_dev = dev is not None and "CUDA" in str(dev)
        if on_device != is_dev:
            continue
        # a kernel event's own duration; an operator's self time (its
        # children counted apart)
        us = float(e.device_time_total if on_device
                   else e.self_cpu_time_total)
        per_name[e.name] = per_name.get(e.name, 0.0) + us
        per_name_n[e.name] = per_name_n.get(e.name, 0) + 1
    total_us = sum(per_name.values())
    grouped = {}
    for name, us in per_name.items():
        base = re.sub(r"<.*$", "", name)
        grouped[base] = grouped.get(base, 0.0) + us
    n = max(int(steps), 1)
    kernel_events = {}
    for wrapper in launched:
        mark = _MARK_KERNEL.get(wrapper, wrapper)
        kernel_events[wrapper] = sum(
            c for name, c in per_name_n.items() if mark in name)
    return json_safe({
        "steps": int(steps),
        "wall_s_per_step": wall / n,
        "on_device": on_device,
        "busy_us_per_step": total_us / n,
        "by_kind": [{"name": k, "us_per_step": us / n,
                     "pct": 100.0 * us / max(total_us, 1)}
                    for k, us in sorted(grouped.items(),
                                        key=lambda kv: -kv[1])][:int(top)],
        "top": [{"name": k, "us_per_step": us / n,
                 "pct": 100.0 * us / max(total_us, 1),
                 "count": per_name_n.get(k, 0)}
                for k, us in sorted(per_name.items(),
                                    key=lambda kv: -kv[1])[:int(top)]],
        "launches": launched,
        "kernel_events": kernel_events,
        # wrappers sharing a device kernel (a tile variant and its
        # default) share its events: compare their sums
        "complete": (not on_device) or all(
            sum(c for w, c in launched.items()
                if _MARK_KERNEL.get(w, w) == _MARK_KERNEL.get(k, k))
            <= kernel_events.get(k, 0) for k in launched),
    })


__all__ = [
    "COMPILE_LOG", "CompileLog", "CompileRecord", "MemorySampler",
    "attribute", "compile_site", "current_site", "enabled",
    "memory_section", "note_compile", "profile", "sample_device_memory",
    "template_feed",
]
