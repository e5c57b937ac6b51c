"""Device-memory watermarks (counterpart of the memory half of
paddle_tpu/obs/perf.py: ``sample_device_memory`` :293 and
``memory_section`` :342).

Each sample sets ``paddle_tpu_device_bytes_live{device}`` and, where the
source reports one, ``paddle_tpu_device_bytes_peak{device}``. The sources
are measurements, named per device in the sample:

* ``cuda_allocator`` — on each card this process has initialised,
  ``torch.cuda.memory_allocated`` and ``max_memory_allocated`` (the
  caching allocator's bytes in tensors; the reference reads the backend's
  ``memory_stats`` where it has one, and walks ``jax.live_arrays()``
  where it has not);
* ``process_rss`` — where no card is in use, the process's resident set
  (``/proc/self/statm``) and its peak (``getrusage``'s ``ru_maxrss``):
  host bytes, which is where a CPU run's tensors live. Where neither can
  be read, the sample holds no device rather than a made-up number.

The reference's compile telemetry, cost attribution and HLO reports
(the rest of its perf.py) have no counterpart here yet.
"""

from __future__ import annotations

import os

from .metrics import REGISTRY as _METRICS, json_safe

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


__all__ = ["sample_device_memory", "memory_section"]
