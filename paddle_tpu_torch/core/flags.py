"""Global flags registry (counterpart of paddle_tpu/core/flags.py), holding
only the flags the ported paths read: the executor's debug and metering
flags (``check_nan_inf``, ``benchmark``, ``obs_op_metrics``), the program
verifier's (``verify_passes``, ``executor_verify``), ``kernel_tier``,
``serving_batch_buckets``, the generation-serving flags (reference
:216-330), the serving front door's (``rpc_timeout_s``,
``serving_max_delay_ms``, ``serving_max_models`` and the tenant quota
flags), the parameter server's (``pserver_barrier_timeout_s``,
``pserver_trainer_lease_s``, ``pserver_wire_dtype``) and the observability
plane's (``obs_metrics_window``, ``obs_slo_interval_s``,
``obs_flight_events``, ``obs_incident_dir``), the serving fleet's and
the perf plane's (``serving_fleet_replicas``, ``serving_probe_interval_ms``,
``serving_probation_probes``, ``serving_exec_cache*``,
``serving_kv_spill_*``, ``serving_autoscale_*``, ``obs_compile_*``,
``kernel_autotune*``), the online-learning loop's (``online_*``) and the
placement planner's (``plan_*``), each with the reference's default."""

from __future__ import annotations

_FLAGS: dict[str, dict] = {}
_FLAGS_VERSION = 0


def flags_version():
    """A counter of the registry's changes (DEFINE_flag, set_flags;
    reference :23)."""
    return _FLAGS_VERSION


def _bump_version():
    global _FLAGS_VERSION
    _FLAGS_VERSION += 1


def DEFINE_flag(name, default, help_str=""):
    if name not in _FLAGS:
        _FLAGS[name] = {"value": default, "default": default,
                        "help": help_str, "type": type(default)}
        _bump_version()
    return _FLAGS[name]["value"]


def get_flag(name):
    return _FLAGS[name]["value"]


def set_flags(flags: dict):
    """fluid.set_flags({'kernel_tier': 'torch'}) — unknown flags raise; a
    bool flag takes "1"/"true"/"yes"/"on" (any case) as true."""
    for name, value in flags.items():
        if name not in _FLAGS:
            raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
        ty = _FLAGS[name]["type"]
        if ty is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes", "on")
        _FLAGS[name]["value"] = ty(value)
        _bump_version()


def flags():
    """Every flag's value, by name (reference :58)."""
    return {n: f["value"] for n, f in _FLAGS.items()}


def init_flags(argv):
    """Set each ``--name=value`` entry of ``argv`` that names a flag (the
    reference's core.init_gflags(argv) contract); returns the entries it
    did not consume."""
    rest = []
    for a in argv:
        if a.startswith("--") and "=" in a:
            name, value = a[2:].split("=", 1)
            if name in _FLAGS:
                set_flags({name: value})
                continue
        rest.append(a)
    return rest


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

DEFINE_flag("pserver_barrier_timeout_s", 60.0,
            "parameter-server wait bound in seconds: how long a sync-mode "
            "push waits at the fan-in barrier (and an async push waits on "
            "bounded staleness) before declaring the round broken by a dead "
            "peer and raising TimeoutError. Overridable per server via "
            "ParameterServer(barrier_timeout_s=...)/serve(); the flag is "
            "the process-wide default (was a hardcoded 60.0)")

DEFINE_flag("pserver_trainer_lease_s", 10.0,
            "heartbeat-lease duration in seconds for sync-mode trainer "
            "membership on a parameter-server shard. A trainer that calls "
            "register_trainer joins the shard's lease set (pushes and "
            "further registrations renew it); a sync round's barrier waits "
            "on the lease set snapshotted at round-open, and a member "
            "whose lease expires mid-round SHRINKS the barrier instead of "
            "timing it out. 0 disables lease bookkeeping entirely "
            "(count-based fan_in barriers only). Overridable per server "
            "via ParameterServer(trainer_lease_s=...)/serve()")

DEFINE_flag("pserver_wire_dtype", "fp32",
            "dtype dense gradients travel in on the trainer->pserver push "
            "wire: fp32 (exact, default) or fp16 (half the push bytes; "
            "the server upcasts and accumulates in fp32, the reference's "
            "half-precision parameter-server transfer). Pulled params "
            "always return fp32")

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

DEFINE_flag("serving_fleet_replicas", 2,
            "default replica count for serving.FleetSupervisor: how many "
            "supervised ModelServer child processes serve one registry "
            "model (each on a fixed address, restarted from the "
            "registry's current version on crash)")

DEFINE_flag("serving_probe_interval_ms", 100.0,
            "how often the serving FleetClient's background prober "
            "health-checks EJECTED replicas (healthy replicas are not "
            "probed — real traffic is their probe)")

DEFINE_flag("serving_probation_probes", 2,
            "consecutive successful health probes an ejected replica "
            "must pass before the FleetClient re-admits it to the "
            "routing set — one lucky probe doesn't un-eject a flapping "
            "replica")

DEFINE_flag("serving_exec_cache", True,
            "whether serving engines LOAD persisted warm executables "
            "(serving/execcache.py: a torch.export program of one bucket "
            "and fetch list, the kernels kept as torch.library operators): "
            "a bundle's published warm/ artifacts (read-only) or the "
            "serving_exec_cache_dir local cache. Every artifact is "
            "fingerprint-checked (bundle content hash, feed shapes/dtypes, "
            "kernel_tier and the autotune flags, torch and CUDA versions, "
            "device name and capability, the TF32 switches, the kernel "
            "sources' hashes) — any mismatch is a silent miss followed by "
            "the eager path. False = always run eagerly, the pre-cache "
            "behavior even on warmed bundles")

DEFINE_flag("serving_exec_cache_dir", "",
            "per-process READ-WRITE warm-executable cache directory for "
            "bundles without published warm/ artifacts: engine warmup "
            "exports and saves each executable there and later engines on "
            "the same bundle bytes load instead. Empty (default) disables "
            "the local cache; published registry versions use their own "
            "<version>/warm/ dir regardless (see ModelRegistry.warm / "
            "publish(warm_cache=True))")

DEFINE_flag("serving_kv_spill_dir", "",
            "per-process READ-WRITE persistent KV-prefix spill directory "
            "(serving/generate/kvstore.py): when set, the paged arena's "
            "LRU eviction DEMOTES refcount-0 registered prefix blocks to "
            "this host-RAM/disk tier instead of discarding them, and "
            "attach_prefix restores spilled blocks into the arena with "
            "zero prefill steps on a hash-chain hit. Every artifact is "
            "fingerprint-checked (bundle content hash, arena geometry, "
            "kernel_tier, torch and CUDA versions, device) — any mismatch "
            "is a silent miss followed by a normal prefill. Empty "
            "(default) disables spilling; published registry versions use "
            "their own <version>/kv/ dir regardless (see "
            "ModelRegistry.warm / publish(kv_prompts=...))")

DEFINE_flag("serving_kv_spill_bytes", 0,
            "byte budget for the serving_kv_spill_dir tier: when > 0, "
            "writing a KV artifact that would push the directory past the "
            "budget first evicts the oldest artifacts (mtime order) until "
            "the new one fits; an artifact bigger than the whole budget "
            "is not written at all. 0 (default) = unbounded. Published "
            "<version>/kv/ dirs are read-only and never evict")

DEFINE_flag("serving_autoscale_min_replicas", 1,
            "floor the serving FleetAutoscaler never scales below: "
            "idle polls retire replicas one at a time down to this "
            "count and no further")

DEFINE_flag("serving_autoscale_max_replicas", 4,
            "ceiling the serving FleetAutoscaler never scales above: "
            "a burning SLO rule spawns replicas one canary-gated step "
            "at a time up to this count and no further")

DEFINE_flag("serving_autoscale_queue_depth", 8.0,
            "objective for the FleetAutoscaler's default SLO rule: the "
            "fleet-summed paddle_tpu_server_queue_depth a replica set "
            "should stay under. Sustained burn over the rule's windows "
            "triggers a warm scale-out; zero depth with zero burn "
            "counts toward scale-in idle polls")

DEFINE_flag("serving_autoscale_idle_polls", 3,
            "consecutive idle FleetAutoscaler polls (no burning rule, "
            "empty fleet queues) before ONE replica is retired — "
            "scale-in damping so a burst lull doesn't thrash the fleet")

DEFINE_flag("obs_compile_log", 256,
            "capacity of the per-process obs.perf CompileLog ring: how "
            "many recent CompileRecords (site, wall seconds, executable "
            "identity) are retained for stats(); 0 disables compile "
            "telemetry entirely (no histogram observations, no records, "
            "no 'compile' flight events). The port's compiles are a "
            "signature's first eager dispatch, a torch.export trace, an "
            "artifact load and an nvcc kernel build")

DEFINE_flag("obs_compile_cost", False,
            "harvest FLOPs into each CompileRecord: the port counts them "
            "with torch.utils.flop_counter.FlopCounterMode over the "
            "compiled dispatch (obs.perf.attribute), which runs it a "
            "second time — a profiling-session switch, off by default")

DEFINE_flag("kernel_autotune", True,
            "consult the attached kernel-tuning table (ops.autotune) "
            "when routing tunable kernels under kernel_tier=auto; off "
            "means pure static routing even with a table attached")

DEFINE_flag("kernel_autotune_dir", "",
            "local directory of kernel-tuning-table artifacts "
            "(.jtune) consulted read-only when an engine's bundle has "
            "no published tune/ dir; empty (default) disables the "
            "local-dir fallback. The attached table's identity is "
            "carried by kernel_autotune_digest")

DEFINE_flag("kernel_autotune_digest", "",
            "content digest of the process-wide ATTACHED kernel-tuning "
            "table; set and cleared by ops.autotune.attach_table/"
            "detach_table, not by hand. An engine routing by its own "
            "bundle's table carries that table's digest instead; either "
            "flows into execcache fingerprints (a warm executable "
            "exported under table X never loads where table Y routes)")

DEFINE_flag("kernel_autotune_bf16", False,
            "allow the tuner to consider, and tuned dispatch to "
            "select, bf16-flagged kernel variants (value-changing "
            "reduced-precision activations, e.g. conv_bn pallas_bf16). "
            "Off (default) keeps every tunable selection bitwise "
            "against static routing: a table then picks among the "
            "float32 kernel variants (pallas, pallas_db, bitwise the "
            "same) where the kernel runs, and the plain chain only "
            "where it cannot; a table entry naming a bf16 variant is "
            "ignored without this opt-in")

DEFINE_flag("online_publish_every_steps", 100,
            "how many global steps the online StreamingTrainer trains "
            "between freeze/publish triggers (online/trainer.py). 0 "
            "disables the step trigger; the time trigger "
            "(online_publish_every_s) still applies. The trigger fires at "
            "a step BOUNDARY (after the push acked on every shard), which "
            "is what makes the freezer's cut barrier-consistent")

DEFINE_flag("online_publish_every_s", 0.0,
            "wall-clock publish trigger for the online StreamingTrainer: "
            "freeze/publish when this many seconds elapsed since the last "
            "successful freeze request, checked at step boundaries. 0.0 "
            "(default) disables the time trigger — step cadence "
            "(online_publish_every_steps) drives publishes alone")

DEFINE_flag("online_trainers_min", 1,
            "lower bound on the online TrainerPool's worker count: the "
            "backlog-driven autoscaler never retires below this many "
            "StreamingTrainer workers, and the pool hot-joins "
            "replacements for crashed workers back up to it "
            "(online/pool.py)")

DEFINE_flag("online_trainers_max", 4,
            "upper bound on the online TrainerPool's worker count: a "
            "Master-backlog spike grows the pool (one hot-join per "
            "autoscaler poll while the scale-up SloRule burns) up to "
            "this many StreamingTrainer workers, never past it")

DEFINE_flag("online_min_serve_s", 2.0,
            "rollout hysteresis: the RolloutController will not start a "
            "new rolling_reload until the currently served version has "
            "been serving this long — a flapping trainer publishing "
            "every few steps cannot churn the fleet; intermediate "
            "versions are skipped (the controller always rolls to the "
            "newest published version)")

DEFINE_flag("online_rollout_poll_ms", 250.0,
            "how often the online RolloutController polls the "
            "ModelRegistry for a newer published version than the fleet "
            "is serving")

DEFINE_flag("online_registry_keep", 0,
            "when > 0, the RolloutController garbage-collects the "
            "registry after each successful rollout via "
            "ModelRegistry.gc(keep_latest=N) — old version dirs are "
            "pruned, but never the currently-served, pinned, latest, or "
            "rollback-target (previous) versions. 0 (default) disables "
            "gc: every published version is retained")

DEFINE_flag("plan_memory_budget_bytes", 0,
            "per-device memory budget the placement planner "
            "(parallel.planner) prunes mesh candidates against — a "
            "candidate whose modeled per-device bytes (params + grads + "
            "optimizer state + activations) exceed the budget is marked "
            "pruned with a why-note and never ranked; 0 (default) "
            "disables the budget. Part of the plan fingerprint")

DEFINE_flag("plan_max_candidates", 16,
            "maximum ranked candidates a PlacementReport keeps; the "
            "search still costs every legal mesh, then drops the tail "
            "past this cap (the report records how many were dropped). "
            "0 keeps everything. Part of the plan fingerprint")

DEFINE_flag("plan_cache_dir", "",
            "local directory of placement-plan artifacts (.jplan) "
            "consulted read-write by parallel.planner.plan() when no "
            "published bundle plan/ dir applies: a fingerprint-matching "
            "artifact skips the search (paddle_tpu_plan_cache_hits), a "
            "fresh search persists its report there; empty (default) "
            "disables the local cache. The plan only chooses the mesh "
            "and ShardingPlan arguments; the sharded step's identity is "
            "theirs")
