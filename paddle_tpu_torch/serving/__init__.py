"""Serving (counterpart of paddle_tpu/serving/): a model server that keeps
the card fed under concurrent traffic.

* :class:`InferenceEngine` (engine.py) — a ``load_inference_model`` bundle
  with bucket-padded execution.
* :class:`DynamicBatcher` (batcher.py) — coalesces concurrent requests
  into one bucket-sized batch under a ``max_delay_ms`` deadline, with
  bounded-queue backpressure (:class:`ServerOverloaded`);
  :class:`TenantQuotas` / :class:`QuotaExceeded` are per-tenant token
  buckets.
* :class:`ModelServer` / :class:`InferClient` (server.py / client.py) — a
  multi-threaded, multi-model server over ``distributed/rpc.py``'s framed
  codec with health/stats RPCs, zero-downtime reload, graceful drain and
  retry-surviving clients.
* the generation subsystem (``serving/generate``): GenerationEngine over a
  paged KV cache, ContinuousBatcher, and the streaming :class:`GenClient`.

The reference's fleet plane (ModelRegistry, FleetSupervisor, FleetClient,
FleetAutoscaler) and its warm-executable cache (ExecCache) are not ported
yet.
"""

from .engine import InferenceEngine, parse_buckets
from .batcher import (DynamicBatcher, QuotaExceeded, ServerOverloaded,
                      TenantQuotas)
from .server import ModelServer
from .client import InferClient
from .generate import (CacheExhausted, ContinuousBatcher, GenClient,
                       GenerationEngine, NoFreeSlots, PagedKVCache,
                       TokenStream, normalize_sampling)

__all__ = ["InferenceEngine", "parse_buckets", "DynamicBatcher",
           "ServerOverloaded", "QuotaExceeded", "TenantQuotas",
           "ModelServer", "InferClient", "CacheExhausted",
           "ContinuousBatcher", "GenerationEngine", "NoFreeSlots",
           "PagedKVCache", "TokenStream", "normalize_sampling", "GenClient"]
