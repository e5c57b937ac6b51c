"""paddle_tpu_torch.obs — the observability plane (counterpart of
paddle_tpu/obs/).

* :mod:`.metrics` — the process-wide :data:`~.metrics.REGISTRY` of named
  ``Counter``/``Gauge``/``Histogram`` families (the reference's names),
  scraped by every ``RpcServer``'s built-in ``metrics`` method, and
  :func:`~.metrics.json_safe`, the wire-safety coercion of every
  ``stats()``/``health()`` payload.
* :mod:`.trace` — trace ids made at client edges, carried in the RPC
  header and restored server-side.
* :mod:`.slo` — declarative SLO rules evaluated by a background
  ``SloMonitor``; breach verdicts surface in ``ModelServer.health()``.
* :mod:`.recorder` — the per-process flight recorder (the built-in
  ``flight_dump`` RPC) and incident bundles.
* :mod:`.perf` — compile telemetry (:data:`~.perf.COMPILE_LOG`,
  :func:`~.perf.note_compile`), device-memory watermarks
  (:func:`~.perf.sample_device_memory`, :class:`~.perf.MemorySampler`),
  cost attribution of one dispatch (:func:`~.perf.attribute`) and device
  traces (:func:`~.perf.profile`).
"""

from . import metrics, perf, recorder, slo, trace
from .metrics import (Counter, Gauge, Histogram, REGISTRY, json_safe,
                      merge_snapshots, next_instance, prometheus_text,
                      scrape)
from .perf import (COMPILE_LOG, MemorySampler, attribute, memory_section,
                   note_compile, profile, sample_device_memory)
from .recorder import (FlightRecorder, IncidentCollector, RECORDER,
                       capture_bundle, record)
from .slo import SloBreach, SloMonitor, SloRule
from .trace import (current_trace_id, new_trace_id, set_trace_id,
                    reset_trace_id, trace_context)

__all__ = [
    "metrics", "trace", "slo", "recorder", "perf", "REGISTRY", "Counter",
    "Gauge", "Histogram", "json_safe", "merge_snapshots", "next_instance",
    "prometheus_text", "scrape", "current_trace_id", "new_trace_id",
    "set_trace_id", "reset_trace_id", "trace_context", "SloRule",
    "SloMonitor", "SloBreach", "FlightRecorder", "IncidentCollector",
    "RECORDER", "record", "capture_bundle", "sample_device_memory",
    "memory_section", "COMPILE_LOG", "MemorySampler", "attribute",
    "note_compile", "profile",
]
