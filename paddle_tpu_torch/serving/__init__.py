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

On top of the single server sits the fleet control plane:

* :class:`ModelRegistry` (registry.py) — versioned, content-hashed store of
  ``save_inference_model`` bundles (a version is visible only once its
  manifest lands atomically), with the ``warm/``, ``kv/`` and ``tune/``
  sidecars.
* :class:`FleetSupervisor` (fleet.py) — N spawned replica processes on
  fixed addresses with ``rolling_reload``: canary-gated, zero-downtime
  version rollouts that roll back a failed canary (:class:`CanaryFailed`).
* :class:`FleetClient` (router.py) — client-side balancer: power-of-two
  choices, connection-failure failover, overload spillover, and health
  probes that eject and probation-readmit replicas.
* :class:`FleetAutoscaler` (autoscale.py) — SLO burn rate and queue depth
  to replica count, one canary-gated replica per poll.
* :class:`ExecCache` (execcache.py) — the persistent warm-executable cache:
  a bucket's ``torch.export`` program next to the bundle, keyed by a full
  identity fingerprint.
"""

from .execcache import ExecCache
from .engine import InferenceEngine, parse_buckets
from .batcher import (DynamicBatcher, QuotaExceeded, ServerOverloaded,
                      TenantQuotas)
from .server import ModelServer
from .client import InferClient
from .registry import ModelRegistry
from .fleet import CanaryFailed, FleetSupervisor
from .router import FleetClient
from .autoscale import FleetAutoscaler
from .generate import (CacheExhausted, ContinuousBatcher, GenClient,
                       GenerationEngine, NoFreeSlots, PagedKVCache,
                       TokenStream, normalize_sampling)

__all__ = ["InferenceEngine", "parse_buckets", "DynamicBatcher",
           "ServerOverloaded", "QuotaExceeded", "TenantQuotas",
           "ModelServer", "InferClient", "ModelRegistry", "ExecCache",
           "FleetSupervisor", "CanaryFailed", "FleetClient",
           "FleetAutoscaler", "CacheExhausted",
           "ContinuousBatcher", "GenerationEngine", "NoFreeSlots",
           "PagedKVCache", "TokenStream", "normalize_sampling", "GenClient"]
