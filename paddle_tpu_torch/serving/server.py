"""ModelServer: a multi-threaded dynamic-batching server, one endpoint,
N hosted models (counterpart of paddle_tpu/serving/server.py, ported
whole but for the warm-executable cache).

The server always has a DEFAULT model (the constructor's) and can host
further engines keyed by name via :meth:`ModelServer.add_model` —
feed-forward and generative side by side behind the same RPC endpoint,
routed by the optional ``model=`` field on ``infer``/``generate``.
Hosted-model count is bounded by ``serving_max_models``: adding past the
budget evicts the least-recently-used IDLE hosted model (refcount-aware
— a model with in-flight requests is never a candidate, and the default
model never evicts). Per-tenant token-bucket quotas
(:class:`~.batcher.TenantQuotas`) enforce at the same surface via the
optional ``tenant=`` field, rejecting typed :class:`QuotaExceeded`.

Transport is ``distributed/rpc.py``'s framed codec — feed and fetch
arrays travel as raw numpy buffers both directions, one thread per client
connection, so N concurrent clients decode/encode in parallel while their
requests coalesce in the DynamicBatcher into bucket-sized engine
dispatches. Engines run on the card (``cuda:0``) unless the caller hands
in an ``engine=`` built with ``place=CPUPlace()``; the engines the server
builds later (``add_model``, ``reload``) run on its default engine's
device. The connection threads and the batcher's worker reach the
engine through its dispatch lock, and every payload leaves as numpy and
builtins (``json_safe``).

RPC surface (all reachable through :class:`~.client.InferClient` and
:class:`~.generate.client.GenClient`):

* ``infer(feed=...)`` — run one request; the answer is the engine's fetch
  list trimmed to the request's rows. Stateless and idempotent, so
  clients retry it safely through server restarts (rpc.RetryPolicy).
* ``generate(prompt=..., max_new_tokens=...)`` — a streaming response,
  one frame of token ids per scheduler emission.
* ``health()`` — cheap liveness: status, queue depth, warmed flag, the
  serving model ``version``, memory and SLO verdicts.
* ``stats()`` — engine counters, batcher queue/batch histogram,
  request-latency p50/p99, WireStats, ``version`` and ``reloads``.
* ``reload(model_dir=..., version=...)`` — zero-downtime hot swap: the new
  engine is built and warmed off the hot path, then swapped in under the
  engine lock; a generative reload hands its wait queue to the new
  scheduler.

Shutdown is a graceful DRAIN by default: stop accepting, let every
in-flight request finish and be answered, then close —
``shutdown(drain=False)`` and ``kill()`` keep the abrupt forms.

The reference's persistent warm-executable cache (``exec_cache=``,
serving/execcache.py) has no counterpart yet: passing one raises
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..core.executor import CPUPlace, CUDAPlace
from ..core.flags import get_flag
from ..distributed.rpc import RpcServer
from ..obs import perf as _perf, recorder as _flight, slo as _slo
from ..obs.metrics import REGISTRY as _METRICS, json_safe, next_instance
from .batcher import DynamicBatcher
from .engine import InferenceEngine

# per-request serving latency (time-to-first-frame for generative):
# a registry histogram (LatencyWindow-backed) per server instance —
# spans still land in chrome traces under "serving/request"
_M_REQUEST_SECONDS = _METRICS.histogram(
    "paddle_tpu_serving_request_seconds",
    "ModelServer per-request latency window (p50/p99), per instance",
    labels=("instance",), span_name="serving/request", span_kind="rpc")

MODEL_KINDS = ("feedforward", "generative")


def sniff_model_kind(model_dir):
    """``model_kind`` of the bundle at ``model_dir``: read from the
    registry's VERSION.json when the dir is a published registry version,
    else (plain export dirs, pre-upgrade manifests) the feed-forward
    default — no migration needed."""
    try:
        with open(os.path.join(model_dir, "VERSION.json")) as f:
            kind = json.load(f).get("model_kind", "feedforward")
    except (OSError, TypeError, ValueError):
        return "feedforward"
    return kind if kind in MODEL_KINDS else "feedforward"


class _HostedModel:
    """One named engine slot in a multi-model :class:`ModelServer`: the
    engine, its batching layer, and the LRU/refcount bookkeeping the
    evictor reads (``inflight``/``last_used`` mutate under the server's
    ``_models_lock``; a model with ``inflight > 0`` is never an eviction
    candidate)."""

    __slots__ = ("name", "engine", "batcher", "model_kind", "model_dir",
                 "version", "buckets", "gen_opts", "continuous",
                 "reloads", "inflight", "last_used")

    def __init__(self, name, engine, model_kind, model_dir, version,
                 buckets, gen_opts, continuous):
        self.name = name
        self.engine = engine
        self.batcher = None
        self.model_kind = model_kind
        self.model_dir = model_dir
        self.version = version
        self.buckets = buckets
        self.gen_opts = gen_opts
        self.continuous = continuous
        self.reloads = 0
        self.inflight = 0
        self.last_used = time.monotonic()


class _ServingHandler:
    """The RPC-visible surface (RpcServer dispatches public methods).
    ``model``/``tenant`` default to None and old clients omit them, so
    the single-model request shapes stay bitwise what they were."""

    def __init__(self, server):
        self._server = server

    def infer(self, feed, model=None, tenant=None):
        return self._server.run_infer(feed, model=model, tenant=tenant)

    def generate(self, prompt, max_new_tokens, sampling=None, model=None,
                 tenant=None):
        return self._server.run_generate(prompt, max_new_tokens, sampling,
                                         model=model, tenant=tenant)

    def health(self):
        return self._server.health()

    def stats(self):
        return self._server.stats()

    def reload(self, model_dir, version=None, model=None):
        return self._server.reload(model_dir, version=version, model=model)

    def add_model(self, name, model_dir, version=None, model_kind=None,
                  buckets=None, gen_opts=None, queue_capacity=None,
                  max_delay_ms=None, continuous=True):
        return self._server.add_model(
            name, model_dir=model_dir, version=version,
            model_kind=model_kind, buckets=buckets, gen_opts=gen_opts,
            queue_capacity=queue_capacity, max_delay_ms=max_delay_ms,
            continuous=continuous)

    def remove_model(self, name):
        return self._server.remove_model(name)


class ModelServer:
    """Serve one saved inference model.

        server = ModelServer(model_dir)            # batching on
        server.start()                             # warmup + serve
        ... InferClient(server.address).infer(...) ...
        server.reload(new_model_dir, version=2)    # zero-downtime swap
        server.shutdown()                          # graceful drain

    ``batching=False`` dispatches each request through the engine
    individually (the A/B baseline the bench lane measures against).
    ``engine=`` substitutes a pre-built engine (shared scope, custom
    buckets, warmed before the address binds, or on the CPU:
    ``engine=InferenceEngine(model_dir, place=fluid.CPUPlace())``); the
    engines ``add_model`` and ``reload`` build run on the default engine's
    device; ``version=`` labels what is serving
    (surfaced by health/stats); ``fault_plan=`` reaches the underlying
    RpcServer for deterministic crash injection in tests."""

    def __init__(self, model_dir=None, engine=None, address=("127.0.0.1", 0),
                 batching=True, max_delay_ms=None, queue_capacity=None,
                 buckets=None, fault_plan=None, version=None,
                 model_kind=None, continuous=True, gen_opts=None,
                 slo_rules=None, exec_cache=None, tenant_quotas=None,
                 max_models=None):
        from .generate import ContinuousBatcher, GenerationEngine
        if exec_cache is not None:
            raise NotImplementedError(
                "the warm-executable cache is not ported yet (reference "
                "serving/execcache.py); leave exec_cache unset")
        # multi-model hosting state: named engines keyed by model name,
        # bounded by max_models (default serving_max_models) with a
        # refcount-aware LRU evictor; the DEFAULT model lives in the
        # server's own fields and is never an eviction candidate
        self._models = {}
        self._models_lock = threading.Lock()
        self._max_models = int(get_flag("serving_max_models")
                               if max_models is None else max_models)
        self._quotas = tenant_quotas
        if model_kind is None:
            if engine is not None:
                model_kind = "generative" \
                    if isinstance(engine, GenerationEngine) else "feedforward"
            else:
                model_kind = sniff_model_kind(model_dir)
        if model_kind not in MODEL_KINDS:
            raise ValueError(f"model_kind must be one of {MODEL_KINDS}, "
                             f"got {model_kind!r}")
        self.model_kind = model_kind
        self._gen_opts = dict(gen_opts or {})
        self._continuous = bool(continuous)
        if engine is None:
            if model_kind == "generative":
                engine = GenerationEngine(model_dir, **self._gen_opts)
            else:
                engine = InferenceEngine(model_dir, buckets=buckets)
        self.engine = engine
        self.model_dir = model_dir
        # the reload path rebuilds engines with the SAME bucket set, so
        # the batcher's coalesce target stays valid across swaps
        self._buckets = list(engine.buckets) \
            if model_kind == "feedforward" else None
        self.batching = bool(batching)
        # _engine_lock guards the engine REFERENCE (reload swaps it);
        # dispatches read the reference under it and run outside it, so
        # in-flight batches finish on the engine they started on
        self._engine_lock = threading.Lock()
        self._reload_lock = threading.Lock()   # serializes reloads
        self._version = version
        self._reloads = 0
        if model_kind == "generative":
            # the scheduler IS the batching layer for stateful decode:
            # it cannot be turned off, so reject the contradiction loud
            # instead of reporting batching=False over a live batcher
            if not self.batching:
                raise ValueError(
                    "a generative ModelServer always runs its "
                    "ContinuousBatcher (the decode scheduler); "
                    "batching=False is not available — use "
                    "continuous=False for gang-scheduled batching")
            self.batcher = ContinuousBatcher(engine,
                                             capacity=queue_capacity,
                                             continuous=continuous)
        elif self.batching:
            self.batcher = DynamicBatcher(
                self._engine_infer, max_batch=engine.max_batch,
                max_delay_ms=max_delay_ms, capacity=queue_capacity)
        else:
            self.batcher = None
        self.obs_instance = next_instance("server")
        self.latency = _M_REQUEST_SECONDS.labels(instance=self.obs_instance)
        self._rpc = RpcServer(_ServingHandler(self), address,
                              fault_plan=fault_plan)
        # slo_rules (SloRule objects or their dict form — the spawned
        # replica child ships dicts): build, INSTALL as the process
        # default (for surfaces with no server at hand) and start
        # evaluating — AFTER the RpcServer bound, so a failed
        # construction never leaks a running process-default monitor.
        # A server-owned monitor stops with the server.
        self._slo_monitor = None
        if slo_rules:
            self._slo_monitor = _slo.SloMonitor(slo_rules)
            self._slo_monitor.install()
            self._slo_monitor.start()
        self._serving = False

    # ------------------------------------------------------------------
    @property
    def address(self):
        return self._rpc.address

    @property
    def version(self):
        return self._version

    def start(self, warmup_feed=None, warmup=True):
        """Warm every bucket (so the serving hot path never compiles),
        then serve in a background thread. Returns the bound address."""
        if warmup:
            self.engine.warmup(warmup_feed)
        self._serving = True
        self._rpc.serve_in_thread()
        return self.address

    def serve_forever(self, warmup_feed=None, warmup=True):
        """Like :meth:`start` but serves in the CALLING thread — the
        fleet replica child entry point (returns when the server is
        killed or shut down)."""
        if warmup:
            self.engine.warmup(warmup_feed)
        self._serving = True
        self._rpc.serve_forever()

    # ------------------------------------------------------------------
    def _place(self):
        """Where the engines this server builds run: its default
        engine's device."""
        dev = self.engine.device
        return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)

    def _current_engine(self):
        with self._engine_lock:
            return self.engine

    def _engine_infer(self, feed, fetch_list=None):
        # read the engine reference under the lock, dispatch outside it:
        # a reload swapping mid-batch never strands this dispatch, it
        # just completes on the engine it started on
        return self._current_engine().infer(feed, fetch_list)

    def run_infer(self, feed, model=None, tenant=None):
        if self._quotas is not None and tenant is not None:
            self._quotas.check(tenant)
        if model is not None:
            return self._run_infer_named(model, feed)
        if self.model_kind != "feedforward":
            raise RuntimeError(
                "this server hosts a GENERATIVE model; call generate() "
                "(GenClient), not infer()")
        with self.latency.span():
            if self.batcher is not None:
                return self.batcher.submit(feed)
            return self._engine_infer(feed)

    # ------------------------------------------------------------------
    # multi-model hosting: named engine slots next to the default model
    # ------------------------------------------------------------------
    def _checkout(self, name):
        """Pin a hosted model for one request: bumps its refcount (the
        evictor never touches inflight > 0) and its LRU clock."""
        with self._models_lock:
            hosted = self._models.get(name)
            if hosted is None:
                raise ValueError(
                    f"unknown model {name!r}; hosted models: "
                    f"{sorted(self._models)} (the default model routes "
                    "with model=None)")
            hosted.inflight += 1
            hosted.last_used = time.monotonic()
            return hosted

    def _checkin(self, hosted):
        with self._models_lock:
            hosted.inflight -= 1

    def _run_infer_named(self, name, feed):
        hosted = self._checkout(name)
        try:
            if hosted.model_kind != "feedforward":
                raise RuntimeError(
                    f"hosted model {name!r} is GENERATIVE; call "
                    "generate() with model=, not infer()")
            with self.latency.span():
                if hosted.batcher is not None:
                    return hosted.batcher.submit(feed)
                with self._models_lock:
                    engine = hosted.engine
                return engine.infer(feed)
        finally:
            self._checkin(hosted)

    def add_model(self, name, model_dir=None, engine=None, version=None,
                  model_kind=None, buckets=None, gen_opts=None,
                  queue_capacity=None, max_delay_ms=None, batching=True,
                  continuous=True, warmup=True):
        """Host another engine under ``name`` next to the default model:
        built (or adopted via ``engine=``) and warmed OFF the hot path,
        then inserted under the models lock. Past the ``max_models``
        budget the least-recently-used IDLE hosted model is evicted
        first (its batcher drains, its engine releases its scope); when
        every candidate has in-flight requests the add fails typed
        instead of over-committing memory. Returns the hosted summary
        including what was evicted."""
        from .generate import ContinuousBatcher, GenerationEngine
        name = str(name)
        if model_kind is None:
            if engine is not None:
                model_kind = "generative" \
                    if isinstance(engine, GenerationEngine) \
                    else "feedforward"
            else:
                model_kind = sniff_model_kind(model_dir)
        if model_kind not in MODEL_KINDS:
            raise ValueError(f"model_kind must be one of {MODEL_KINDS}, "
                             f"got {model_kind!r}")
        with self._models_lock:
            if name in self._models:
                raise ValueError(
                    f"model {name!r} is already hosted; "
                    f"reload(model={name!r}) swaps its version, "
                    "remove_model() frees the slot")
        gen_opts = dict(gen_opts or {})
        if engine is None:
            if model_kind == "generative":
                engine = GenerationEngine(model_dir, place=self._place(),
                                          **gen_opts)
            else:
                engine = InferenceEngine(model_dir, place=self._place(),
                                         buckets=buckets)
        if warmup:
            engine.warmup()
        hosted = _HostedModel(
            name, engine, model_kind, model_dir, version,
            list(engine.buckets) if model_kind == "feedforward" else None,
            gen_opts, bool(continuous))
        if model_kind == "generative":
            hosted.batcher = ContinuousBatcher(engine,
                                               capacity=queue_capacity,
                                               continuous=continuous)
        elif batching:
            def run_batch(feed, fetch_list=None, _h=hosted):
                # read the CURRENT engine under the lock (a named reload
                # swaps it), dispatch outside — same contract as the
                # default model's _engine_infer
                with self._models_lock:
                    eng = _h.engine
                return eng.infer(feed, fetch_list)
            hosted.batcher = DynamicBatcher(
                run_batch, max_batch=engine.max_batch,
                max_delay_ms=max_delay_ms, capacity=queue_capacity)
        evicted = []
        try:
            with self._models_lock:
                if name in self._models:
                    raise ValueError(f"model {name!r} is already hosted")
                # budget counts the default model too: evict idle LRU
                # hosted models until the new one fits
                while 1 + len(self._models) + 1 > self._max_models:
                    victim = self._lru_victim_locked()
                    if victim is None:
                        raise RuntimeError(
                            f"cannot host model {name!r}: the "
                            f"{self._max_models}-model budget is full "
                            "and every eviction candidate has in-flight "
                            "requests")
                    evicted.append(self._models.pop(victim.name))
                self._models[name] = hosted
        except Exception:
            # the slot was never inserted: tear down what was built so a
            # failed add leaks neither a batcher worker nor an engine
            self._release_hosted(hosted)
            raise
        for old in evicted:
            self._release_hosted(old)
            _flight.record("model_evicted", component=self.obs_instance,
                           model=old.name, version=old.version)
        _flight.record("model_added", component=self.obs_instance,
                       model=name, version=version, model_kind=model_kind)
        return {"model": name, "version": version,
                "model_kind": model_kind,
                "evicted": [o.name for o in evicted]}

    def remove_model(self, name):
        """Free ``name``'s slot: refuses while requests are in flight
        (drain first), else drains its batcher and releases its engine."""
        name = str(name)
        with self._models_lock:
            hosted = self._models.get(name)
            if hosted is None:
                raise ValueError(f"unknown model {name!r}; hosted "
                                 f"models: {sorted(self._models)}")
            if hosted.inflight:
                raise RuntimeError(
                    f"model {name!r} has {hosted.inflight} in-flight "
                    "request(s); drain before remove_model()")
            del self._models[name]
        self._release_hosted(hosted)
        _flight.record("model_removed", component=self.obs_instance,
                       model=name)
        return {"model": name, "removed": True}

    def _lru_victim_locked(self):
        idle = [h for h in self._models.values() if h.inflight == 0]
        if not idle:
            return None
        return min(idle, key=lambda h: h.last_used)

    def _release_hosted(self, hosted, timeout=30.0):
        if hosted.batcher is not None:
            hosted.batcher.close(timeout)
        release = getattr(hosted.engine, "release", None)
        if release is not None:
            release()

    def run_generate(self, prompt, max_new_tokens, sampling=None,
                     model=None, tenant=None):
        """Handler for the streaming ``generate`` RPC: submit to the
        continuous batcher and yield one ``{"tokens": [...]}`` frame per
        scheduler emission — the RpcServer turns the generator into a
        multi-frame streaming response. Closing the generator (client
        vanished mid-stream, drain) cancels the sequence. The latency
        window records TIME TO FIRST FRAME per request (the serving
        metric a token stream has; whole-stream duration is dominated by
        the requested generation length, not the server)."""
        if self._quotas is not None and tenant is not None:
            self._quotas.check(tenant)
        if model is not None:
            return self._run_generate_named(model, prompt, max_new_tokens,
                                            sampling)
        if self.model_kind != "generative":
            raise RuntimeError(
                "this server hosts a FEED-FORWARD model; call infer() "
                "(InferClient), not generate()")
        t0 = time.perf_counter()
        stream = self._submit_generate(prompt, max_new_tokens, sampling)

        def frames():
            first, s = True, stream
            while True:
                try:
                    with s:            # GeneratorExit -> stream.close()
                        for toks in s.batches():
                            if first:
                                self.latency.record(
                                    time.perf_counter() - t0)
                                first = False
                            yield {"tokens": toks}
                    return
                except RuntimeError as e:
                    # a reload raced this request onto the OLD batcher
                    # after its queue handoff: nothing was emitted yet,
                    # so replaying the whole request on the current
                    # batcher is safe (a genuine shutdown re-raises
                    # from _submit_generate instead)
                    if not first or "ContinuousBatcher is closed" \
                            not in str(e):
                        raise
                    s = self._submit_generate(prompt, max_new_tokens,
                                              sampling)
        return frames()

    def _submit_generate(self, prompt, max_new_tokens, sampling):
        """Submit against the CURRENT batcher, retrying across a reload
        swap: reading the batcher reference and submitting to it cannot
        be atomic with the swap, so a submit that lands on a
        just-replaced (closing) batcher retries on its successor. A
        batcher closed while still being the current one is a real
        shutdown — that RuntimeError propagates."""
        while True:
            with self._engine_lock:
                batcher = self.batcher
            try:
                return batcher.submit(prompt, max_new_tokens, sampling)
            except RuntimeError as e:
                if "ContinuousBatcher is closed" not in str(e):
                    raise
                with self._engine_lock:
                    if self.batcher is batcher:
                        raise

    def _run_generate_named(self, name, prompt, max_new_tokens, sampling):
        """:meth:`run_generate` for a hosted model: same frame generator,
        but the model stays PINNED (inflight refcount) for the whole
        stream — the evictor must never drop an engine with a live token
        stream on it."""
        hosted = self._checkout(name)
        submitted = False
        try:
            if hosted.model_kind != "generative":
                raise RuntimeError(
                    f"hosted model {name!r} is FEED-FORWARD; call "
                    "infer() with model=, not generate()")
            t0 = time.perf_counter()
            stream = self._submit_generate_named(hosted, prompt,
                                                 max_new_tokens, sampling)
            submitted = True
        finally:
            if not submitted:
                self._checkin(hosted)

        def frames():
            first, s = True, stream
            try:
                while True:
                    try:
                        with s:        # GeneratorExit -> stream.close()
                            for toks in s.batches():
                                if first:
                                    self.latency.record(
                                        time.perf_counter() - t0)
                                    first = False
                                yield {"tokens": toks}
                        return
                    except RuntimeError as e:
                        # reload raced this request onto the OLD batcher
                        # after its queue handoff — same replay rule as
                        # the default model's frames()
                        if not first or "ContinuousBatcher is closed" \
                                not in str(e):
                            raise
                        s = self._submit_generate_named(
                            hosted, prompt, max_new_tokens, sampling)
            finally:
                self._checkin(hosted)
        return frames()

    def _submit_generate_named(self, hosted, prompt, max_new_tokens,
                               sampling):
        """:meth:`_submit_generate` against a hosted model's batcher
        (a named reload swaps it under the models lock)."""
        while True:
            with self._models_lock:
                batcher = hosted.batcher
            try:
                return batcher.submit(prompt, max_new_tokens, sampling)
            except RuntimeError as e:
                if "ContinuousBatcher is closed" not in str(e):
                    raise
                with self._models_lock:
                    if hosted.batcher is batcher:
                        raise

    def reload(self, model_dir, version=None, model=None):
        """Zero-downtime hot swap to the model at ``model_dir``: build a
        NEW engine (own private scope) and warm every bucket OFF the hot
        path — the old engine keeps serving throughout, so a rollout
        never makes this replica unready — then swap the reference under
        the engine lock. In-flight requests finish on the old engine; its
        scope is dropped with the last reference. Raises (and keeps the
        old engine serving) if the new bundle fails to load
        (``load_inference_model``'s typed ValueError) or fails warmup.
        Returns the new serving version and the warmup compile count.
        ``model=`` reloads a HOSTED model by name instead of the default
        — the other hosted engines (default included) are untouched: no
        swap, no recompile, not even a warm-exec drop."""
        try:
            if model is None:
                out = self._reload_inner(model_dir, version)
            else:
                out = self._reload_named(model, model_dir, version)
        except Exception as e:
            # flight recorder: a rejected reload is a canary verdict in
            # the making — record it under the caller's trace id (the
            # rollout's reload RPC restored it into the contextvar)
            _flight.record("reload_failed", component=self.obs_instance,
                           model_dir=str(model_dir), version=version,
                           model=model, error=f"{type(e).__name__}: {e}")
            raise
        _flight.record("reload", component=self.obs_instance,
                       version=version, model=model,
                       compiles=out.get("compiles"))
        return out

    def _reload_named(self, name, model_dir, version=None):
        """Hot-swap one HOSTED model (same zero-downtime shape as the
        default path, scoped to its slot). The model is pinned for the
        duration so the evictor cannot race the swap."""
        with self._reload_lock:
            hosted = self._checkout(str(name))
            try:
                if hosted.model_kind == "generative":
                    from .generate import (ContinuousBatcher,
                                           GenerationEngine)
                    new_kind = sniff_model_kind(model_dir)
                    if new_kind != "generative":
                        raise ValueError(
                            f"cannot reload a {new_kind!r} bundle into "
                            f"the generative hosted model {name!r}")
                    new = GenerationEngine(model_dir, place=self._place(),
                                           **hosted.gen_opts)
                    compiled = new.warmup()
                    new_batcher = ContinuousBatcher(
                        new, capacity=hosted.batcher.capacity,
                        continuous=hosted.continuous)
                    with self._models_lock:
                        old_batcher = hosted.batcher
                        hosted.engine = new
                        hosted.batcher = new_batcher
                        hosted.model_dir = model_dir
                        hosted.version = version
                        hosted.reloads += 1
                    requeued = old_batcher.transfer_queued(new_batcher)
                    threading.Thread(target=old_batcher.close,
                                     daemon=True).start()
                    return {"version": version, "compiles": compiled,
                            "requeued": requeued, "model": name}
                new = InferenceEngine(model_dir, place=self._place(),
                                      buckets=hosted.buckets)
                compiled = new.warmup()  # off the hot path, like default
                with self._models_lock:
                    hosted.engine = new
                    hosted.model_dir = model_dir
                    hosted.version = version
                    hosted.reloads += 1
                return {"version": version, "compiles": compiled,
                        "model": name}
            finally:
                self._checkin(hosted)

    def _reload_inner(self, model_dir, version=None):
        with self._reload_lock:
            if self.model_kind == "generative":
                from .generate import ContinuousBatcher, GenerationEngine
                new_kind = sniff_model_kind(model_dir)
                if new_kind != "generative":
                    raise ValueError(
                        f"cannot reload a {new_kind!r} bundle into a "
                        "generative server (engine classes differ); "
                        "roll a fresh replica instead")
                new = GenerationEngine(model_dir, place=self._place(),
                                       **self._gen_opts)
                compiled = new.warmup()
                new_batcher = ContinuousBatcher(
                    new, capacity=self.batcher.capacity,
                    continuous=self._continuous)
                with self._engine_lock:
                    old_batcher = self.batcher
                    self.engine = new
                    self.batcher = new_batcher
                    self.model_dir = model_dir
                    self._version = version
                    self._reloads += 1
                # zero-downtime also for the WAIT QUEUE: requests still
                # queued on the old batcher hand off to the new one in
                # FIFO order instead of being rejected at close
                requeued = old_batcher.transfer_queued(new_batcher)
                # in-flight streams keep the OLD engine/batcher through
                # their closures; close it once they drain (non-blocking
                # for the reload caller: sequences finish on their own)
                threading.Thread(target=old_batcher.close,
                                 daemon=True).start()
                return {"version": version, "compiles": compiled,
                        "requeued": requeued}
            new = InferenceEngine(model_dir, place=self._place(),
                                  buckets=self._buckets)
            compiled = new.warmup()          # off the hot path: old engine
            with self._engine_lock:          # still answers during this
                self.engine = new
                self.model_dir = model_dir
                self._version = version
                self._reloads += 1
        return {"version": version, "compiles": compiled}

    def health(self):
        engine = self._current_engine()
        # engine.warmed, NOT engine.stats()["warmed"]: stats() includes
        # a device-memory sample since the perf plane, and health is the
        # cheap-liveness surface — one memory_section() below is the
        # whole memory cost of a health poll
        out = {"status": "serving" if self._serving else "stopped",
               "warmed": engine.warmed,
               "batching": self.batching,
               "model_kind": self.model_kind,
               "version": self._version,
               "queue_depth": 0}
        if self.batcher is not None:
            out["queue_depth"] = self.batcher.stats()["queue_depth"]
        # hosted-model liveness, present only when models are hosted so
        # the single-model health shape stays bitwise what it was
        with self._models_lock:
            hosted = list(self._models.values())
        if hosted:
            out["models"] = {
                h.name: {"model_kind": h.model_kind,
                         "version": h.version,
                         "warmed": h.engine.warmed,
                         "inflight": h.inflight,
                         "queue_depth":
                             h.batcher.stats()["queue_depth"]
                             if h.batcher is not None else 0}
                for h in hosted}
        # memory watermark, sampled per scrape so every health poll (and
        # the SLO rules judging the gauge it refreshes) reads a current
        # number — json-safe; the card's allocator, or on the CPU the
        # process's resident set
        out["memory"] = _perf.memory_section()
        # SLO verdicts on the same surface rollouts and routers already
        # health-gate on: this server's OWN monitor when it has one
        # (two servers in one process must not report each other's
        # rules), else the process-installed default
        if self._slo_monitor is not None:
            out["slo"] = self._slo_monitor.health_section()
        else:
            slo = _slo.health_section()
            if slo is not None:
                out["slo"] = slo
        return json_safe(out)

    def stats(self):
        out = {"engine": self._current_engine().stats(),
               "latency": self.latency.snapshot(),
               "wire": self._rpc.wire_stats.snapshot(),
               "model_kind": self.model_kind,
               "version": self._version,
               "reloads": self._reloads}
        if self.batcher is not None:
            out["batcher"] = self.batcher.stats()
        with self._models_lock:
            hosted = list(self._models.values())
        if hosted:
            out["models"] = {
                h.name: {"engine": h.engine.stats(),
                         "batcher": h.batcher.stats()
                         if h.batcher is not None else None,
                         "model_kind": h.model_kind,
                         "version": h.version,
                         "inflight": h.inflight,
                         "reloads": h.reloads}
                for h in hosted}
        if self._quotas is not None:
            out["quotas"] = self._quotas.stats()
        return json_safe(out)

    # ------------------------------------------------------------------
    def shutdown(self, drain=True, timeout=30.0):
        """Graceful by default: stop accepting, flush in-flight requests
        (every caller gets its answer), then close. Returns True when the
        server went idle within ``timeout``."""
        self._serving = False
        if drain:
            drained = self._rpc.drain(timeout)
        else:
            self._rpc.shutdown()
            drained = True
        if self.batcher is not None:
            # in-flight submits completed during the rpc drain; this
            # flushes nothing in the normal path and joins the worker
            drained = self.batcher.close(timeout) and drained
        with self._models_lock:
            hosted = list(self._models.values())
        for h in hosted:
            if h.batcher is not None:
                drained = h.batcher.close(timeout) and drained
        self._stop_slo_monitor()
        return drained

    def _stop_slo_monitor(self):
        if self._slo_monitor is not None:
            self._slo_monitor.stop()
            if _slo.installed() is self._slo_monitor:
                _slo.install(None)
            self._slo_monitor = None

    def kill(self):
        """Crash simulation (tests): sever everything, no drain — what a
        SIGKILLed serving process looks like to its clients."""
        self._serving = False
        self._rpc.kill()
        self._stop_slo_monitor()


__all__ = ["ModelServer"]
