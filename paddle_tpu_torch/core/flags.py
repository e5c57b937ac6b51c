"""Global flags registry (counterpart of paddle_tpu/core/flags.py), holding
only the flags the ported paths read: the executor's debug and metering
flags (``check_nan_inf``, ``benchmark``, ``obs_op_metrics``), the program
verifier's (``verify_passes``, ``executor_verify``), ``kernel_tier``,
``serving_batch_buckets``, the generation-serving flags (reference
:216-330, without the KV spill tier's ``serving_kv_spill_dir`` and
``serving_kv_spill_bytes``), the serving front door's (``rpc_timeout_s``,
``serving_max_delay_ms``, ``serving_max_models`` and the tenant quota
flags) and the observability plane's (``obs_metrics_window``,
``obs_slo_interval_s``, ``obs_flight_events``, ``obs_incident_dir``), each
with the reference's default."""

from __future__ import annotations

_FLAGS: dict[str, dict] = {}


def DEFINE_flag(name, default, help_str=""):
    if name not in _FLAGS:
        _FLAGS[name] = {"value": default, "default": default,
                        "help": help_str, "type": type(default)}
    return _FLAGS[name]["value"]


def get_flag(name):
    return _FLAGS[name]["value"]


def set_flags(flags: dict):
    """fluid.set_flags({'kernel_tier': 'torch'}) — unknown flags raise."""
    for name, value in flags.items():
        if name not in _FLAGS:
            raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
        _FLAGS[name]["value"] = _FLAGS[name]["type"](value)


DEFINE_flag("check_nan_inf", False,
            "sweep every op's floating outputs for NaN/Inf after the op "
            "runs and raise FloatingPointError naming the op and the "
            "output — reference --check_nan_inf "
            "(framework/executor.cc:325-333). On the card each op then "
            "waits for its own result (one sync per op)")

DEFINE_flag("benchmark", False,
            "print each op's wall time after the op, its device "
            "synchronised first — reference --benchmark "
            "(executor.cc:321-324)")

DEFINE_flag("verify_passes", False,
            "make every program-transforming pass (append_backward, "
            "fuse_conv_bn, the GenerationEngine phase rewrite, "
            "save_inference_model's prune) run fluid.analysis."
            "verify_program over its OUTPUT program and raise a typed "
            "ProgramVerifyError naming the pass on structural damage — "
            "the reference's build-time InferShape/arity net "
            "(op_registry.h), applied at every IR rewrite")

DEFINE_flag("executor_verify", False,
            "verify each program at Executor.run dispatch, once per "
            "(program version, feed/fetch surface), memoized through the "
            "_ProgramAnalysis cache so the steady-state run pays one set "
            "lookup; scope-bound free reads count as dataflow roots")

DEFINE_flag("obs_op_metrics", False,
            "executor observability hooks: per-op-type dispatch and "
            "dispatch-time counters and per-step counters in the "
            "obs.metrics registry. Host-side only; with the flag off the "
            "op loop reads no flag per op")

DEFINE_flag("kernel_tier", "auto",
            "which lowering the hot-op dispatch sites use: 'auto' (the "
            "hand-written kernel for CUDA tensors, the plain PyTorch op "
            "chain for CPU tensors), 'cuda' (the kernel route for every "
            "supported shape; on CPU tensors the kernel wrapper runs its "
            "plain twin), or 'torch' (the plain PyTorch op chain "
            "everywhere). A shape outside a kernel's supported() set routes "
            "to the plain op chain and bumps ops.cuda.fallback_counts()")

DEFINE_flag("serving_batch_buckets", "1,2,4,8,16,32",
            "comma-separated batch buckets the serving InferenceEngine pads "
            "incoming batches up to; batches beyond the largest bucket are "
            "chunked through it (serving/engine.py)")

DEFINE_flag("rpc_timeout_s", 90.0,
            "host-RPC response deadline in seconds: how long RpcClient "
            "waits for a reply before declaring the call timed out "
            "(timeouts are never retried — the call may have applied). "
            "Overridable per client via RpcClient(timeout=)")

DEFINE_flag("serving_max_delay_ms", 5.0,
            "how long the serving DynamicBatcher holds an under-full "
            "batch open for more concurrent requests before dispatching "
            "it anyway — the latency bound a single quiet-traffic "
            "request pays for batching (a full bucket dispatches "
            "immediately)")

DEFINE_flag("serving_queue_capacity", 256,
            "bound on requests waiting in a serving queue (the "
            "DynamicBatcher's and the generation ContinuousBatcher's). When "
            "full, new requests are rejected fast with a typed "
            "ServerOverloaded the client can back off on, instead of "
            "stretching everyone's latency without bound")

DEFINE_flag("serving_max_models", 4,
            "bound on engines a multi-model ModelServer hosts at once: "
            "adding a model past the budget evicts the least-recently-"
            "used IDLE hosted model first (a model with in-flight "
            "requests is never an eviction candidate, and the server's "
            "default model never evicts); when every candidate is busy "
            "the add fails typed instead of over-committing memory")

DEFINE_flag("serving_tenant_rate", 0.0,
            "default per-tenant request rate (tokens per second) for "
            "serving TenantQuotas buckets. Each request spends one "
            "token; an empty bucket rejects typed with QuotaExceeded "
            "carrying the refill ETA. <= 0 (default) means unlimited "
            "unless a tenant has an explicit override")

DEFINE_flag("serving_tenant_burst", 0,
            "default per-tenant token-bucket ceiling for serving "
            "TenantQuotas: how many requests a tenant can burst above "
            "its steady rate. 0 (default) derives ceil(rate) so a "
            "configured rate always admits at least one request")

DEFINE_flag("serving_tenant_label_cap", 16,
            "bound on distinct tenant ids mirrored into the "
            "paddle_tpu_tenant_* metric label set per TenantQuotas "
            "instance: tenant ids arrive off the wire, so past the cap "
            "(or for a non-identifier name) the label funnels into "
            "__other__ exactly like RPC method names — quota "
            "ENFORCEMENT stays exact per tenant either way")

DEFINE_flag("obs_metrics_window", 2048,
            "default sample-window capacity of obs.metrics Histogram "
            "children (each wraps a core.profiler.LatencyWindow ring of "
            "this many recent observations for p50/p99 readout); "
            "families may override per-histogram via window=")

DEFINE_flag("obs_slo_interval_s", 1.0,
            "evaluation period of a background obs.slo.SloMonitor: how "
            "often each declared SLO rule is reduced against a registry "
            "snapshot, its burn rate updated "
            "(paddle_tpu_slo_burn_rate) and its multi-window breach "
            "state re-judged. Overridable per monitor via "
            "SloMonitor(interval_s=)")

DEFINE_flag("obs_flight_events", 2048,
            "capacity of the per-process flight recorder ring "
            "(obs.recorder): how many recent structured lifecycle "
            "events (overload and quota rejects, model adds, evictions "
            "and reloads, ...) each process retains for the built-in "
            "flight_dump RPC and incident bundles. Oldest events are "
            "overwritten (the dropped count is reported in dumps)")

DEFINE_flag("obs_incident_dir", "",
            "directory obs.recorder.IncidentCollector writes incident "
            "bundles (one JSON file per trigger) into; empty (default) "
            "keeps bundles in-memory only (IncidentCollector.bundles, "
            "bounded)")

DEFINE_flag("serving_kv_block_size", 16,
            "tokens per KV-cache block in the generation-serving paged arena "
            "(serving/generate/kvcache.py): each sequence's context occupies "
            "ceil(len/block_size) blocks addressed through its block table. "
            "One block is also the copy-on-write unit for beam forks")

DEFINE_flag("serving_kv_num_blocks", 256,
            "blocks in the pre-allocated per-layer KV arena ([num_blocks, "
            "block_size, heads, head_dim] per layer, K and V). When a "
            "request's worst case cannot be promised from the free blocks, "
            "admission rejects typed with CacheExhausted and the scheduler "
            "keeps it queued")

DEFINE_flag("serving_prefix_cache_blocks", 0,
            "budget of refcount-0 KV blocks the paged arena retains as a "
            "shared-prefix cache instead of recycling eagerly: full prompt "
            "blocks are content-hash-chained at prefill, and a new request "
            "whose prompt starts with a cached chain attaches to those "
            "blocks and prefills only its uncached tail. Evicted least "
            "recently used past the budget or under admission pressure; 0 "
            "disables retention")

DEFINE_flag("serving_prefill_chunk", 0,
            "when > 0, a prompt's uncached prefill runs in chunks of at most "
            "this many tokens, one chunk per decode step boundary, so a long "
            "cold prompt admits without stalling in-flight decode streams. "
            "0 keeps single-dispatch prefill")

DEFINE_flag("serving_max_seqs", 8,
            "decode slots in the generation engine's one fixed-shape "
            "[max_seqs, 1] decode dispatch: the bound on concurrent "
            "in-flight sequences")
