"""InferenceEngine: bucket-padded execution of a saved inference program
(counterpart of paddle_tpu/serving/engine.py:118).

The engine pads each incoming batch up to a small fixed set of batch
buckets (the ``serving_batch_buckets`` flag), chunks batches beyond the
largest bucket through it, and trims every fetch back to the true row count.
Padding rows replicate the batch's last row, which is inert for any per-row
model. A one-level LoD fetch with a row per image (multiclass_nms's
detections) is trimmed as a ``LoDArray`` of its padded rows and lengths; the
reference rejects it as not per-row. The reference pads so each bucket compiles once; this port runs
eagerly, so the same buckets bound the set of shapes the kernels see.

The counters keep the reference's meaning and names
(``paddle_tpu_engine_compiles`` / ``_hits`` / ``_hot_recompiles``, per
instance and bucket): the first dispatch of a (bucket, fetch list, feed
signature) counts as a compile, later ones as hits, and a first dispatch
after :meth:`InferenceEngine.warmup` as a hot recompile. On the card that
first dispatch is the one that builds and loads the kernels and sizes the
allocator's pools for the shape; it lands in obs.perf's compile log
(sites ``engine_warmup`` / ``engine_infer``).

``exec_cache=`` (or the ``serving_exec_cache*`` flags, or a registry
version's ``warm/`` dir) gives each bucket a warm executable
(serving/execcache.py): warmup loads the ``torch.export`` program of the
bucket where a fingerprint-matched artifact exists, or exports and saves
it into a writable cache, and dispatches then run it in place of the op
loop. A dispatch through a loaded executable counts as a hit (nothing was
built), so a fully warm engine's warmup reports 0. An executable that
fails to run is rejected (``run_failed``) and the dispatch falls back to
the op loop on the same device and route. Warmup loads the bundle's
tuning table first (``ops.autotune.load_for_bundle``) and the engine's
dispatches route by it (``ops.autotune.routing``), not by another
engine's, so every artifact's fingerprint carries the routing it was
exported under.
"""

from __future__ import annotations

import bisect
import threading
import time

import numpy as np

from ..core.executor import Executor
from ..core.flags import get_flag
from ..core.lod import LoDArray
from ..core.profiler import record_event
from ..core.scope import Scope
from ..core.types import convert_dtype
from ..fluid import io as fluid_io
from ..obs import perf as _perf
from ..obs.metrics import REGISTRY as _METRICS, json_safe, next_instance
from ..ops import autotune as _autotune
from ..ops import cuda as kernel_tier
from ..ops.cuda import conv_bn
from . import execcache as _execcache

_M_COMPILES = _METRICS.counter(
    "paddle_tpu_engine_compiles",
    "InferenceEngine first dispatches of a (bucket, signature), per engine "
    "instance and bucket",
    labels=("instance", "bucket"))
_M_HITS = _METRICS.counter(
    "paddle_tpu_engine_hits",
    "InferenceEngine repeat dispatches of a seen (bucket, signature), per "
    "engine instance and bucket",
    labels=("instance", "bucket"))
_M_HOT = _METRICS.counter(
    "paddle_tpu_engine_hot_recompiles",
    "first dispatches of a (bucket, signature) AFTER warmup",
    labels=("instance",))


def parse_buckets(spec=None):
    """'1,2,4,8' -> sorted unique positive ints (flag default when None)."""
    if spec is None:
        spec = get_flag("serving_batch_buckets")
    try:
        if isinstance(spec, str):
            vals = [int(s) for s in spec.split(",") if s.strip()]
        else:
            vals = [int(b) for b in spec]
    except (TypeError, ValueError) as e:
        raise ValueError(f"serving batch buckets must be positive ints, "
                         f"got {spec!r} ({e})") from e
    if not vals or any(b <= 0 for b in vals):
        raise ValueError(f"serving batch buckets must be positive ints, "
                         f"got {spec!r}")
    return sorted(set(vals))


def _concat_rows(parts):
    """The chunks' fetches of one name joined along the rows; LoD fetches
    (padded alike, to one width) by their data and lengths."""
    if isinstance(parts[0], LoDArray):
        return LoDArray(np.concatenate([p.data for p in parts], axis=0),
                        np.concatenate([p.lens for p in parts], axis=0))
    return np.concatenate(parts, axis=0)


def _pad_rows(a, bucket):
    """Pad a [n, ...] array up to [bucket, ...] by replicating its last
    row (outputs for the padding rows are discarded by the caller)."""
    pad = bucket - a.shape[0]
    if pad <= 0:
        return a
    return np.concatenate(
        [a, np.broadcast_to(a[-1:], (pad,) + a.shape[1:])], axis=0)


class InferenceEngine:
    """Bucket-padded executor for one saved inference model. Point it at a
    ``save_inference_model`` directory::

        engine = InferenceEngine(model_dir)                 # on cuda:0
        engine = InferenceEngine(model_dir, place=fluid.CPUPlace())

    or hand it an already-loaded bundle (``program``, ``feed_names``,
    ``fetch_vars``, with the ``executor`` and ``scope`` it was loaded
    with). A ``model_dir`` engine loads the bundle's persistables into its
    OWN private scope, so many engines coexist in one process.
    :meth:`infer` serializes dispatches with a lock, whichever thread calls
    it: every tensor lives on the executor's explicit device, and each
    kernel launches on the current stream of that device.
    """

    def __init__(self, model_dir=None, place=None, buckets=None,
                 program=None, feed_names=None, fetch_vars=None,
                 executor=None, scope=None, exec_cache=None):
        self._scope = scope or Scope()
        self._exe = executor or Executor(place)
        if model_dir is not None:
            program, feed_names, fetch_vars = fluid_io.load_inference_model(
                model_dir, self._exe, scope=self._scope)
        if program is None or feed_names is None or fetch_vars is None:
            raise ValueError(
                "InferenceEngine needs model_dir= or all of program=/"
                "feed_names=/fetch_vars=")
        # the warm-executable cache (serving/execcache.py); None = the op
        # loop always, the pre-cache behavior. Without bundle bytes there
        # is no content identity to key artifacts on
        self._model_dir = str(model_dir) if model_dir is not None else None
        self._tune_table = None        # the bundle's, loaded by warmup
        self._exec_cache = _execcache.resolve_cache(model_dir, exec_cache)
        self._bundle_hash = _execcache.bundle_content_hash(model_dir) \
            if self._exec_cache is not None and model_dir else None
        if self._bundle_hash is None:
            self._exec_cache = None
        self._warm_execs = {}          # dispatch sig -> WarmExecutable
        self._warm_loaded = set()      # sigs whose executable was LOADED
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = [v if isinstance(v, str) else v.name
                             for v in fetch_vars]
        self.buckets = parse_buckets(buckets)
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # (bucket, fetch names, feed signature) dispatched so far
        self._seen = set()
        self.obs_instance = next_instance("engine")
        self._m_compiles = {b: _M_COMPILES.labels(instance=self.obs_instance,
                                                  bucket=str(b))
                            for b in self.buckets}
        self._m_hits = {b: _M_HITS.labels(instance=self.obs_instance,
                                          bucket=str(b))
                        for b in self.buckets}
        self._m_hot = _M_HOT.labels(instance=self.obs_instance)
        self._warmed = False

    @property
    def program(self):
        return self._program

    @property
    def device(self):
        return self._exe.device

    @property
    def feed_names(self):
        return list(self._feed_names)

    @property
    def fetch_names(self):
        return list(self._fetch_names)

    @property
    def warmed(self):
        """Whether warmup() ran — the cheap liveness bit health() reads."""
        return self._warmed

    @property
    def hot_recompiles(self):
        """First dispatches of a (bucket, signature) after warmup."""
        return int(self._m_hot.value)

    @property
    def max_batch(self):
        return self.buckets[-1]

    def bucket_for(self, n):
        """Smallest bucket >= n (the largest bucket for oversized n —
        :meth:`infer` chunks those)."""
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    def _template_feed(self):
        """One-row zero feed from the program's feed-var metadata."""
        block = self._program.global_block()
        feed = {}
        for name in self._feed_names:
            v = block.var(name)
            dims = list(v.shape or [])
            if dims and dims[0] == -1:
                dims = dims[1:]
            if v.lod_level or any(d is None or int(d) < 0 for d in dims):
                raise ValueError(
                    f"feed var {name!r} (shape {v.shape}, lod_level "
                    f"{v.lod_level}) needs warmup(sample_feed=...)")
            feed[name] = np.zeros([1] + [int(d) for d in dims],
                                  _np_dtype(v.dtype))
        return feed

    def _normalize_dtypes(self, arrs):
        """Cast feeds to their declared var dtypes."""
        block = self._program.global_block()
        for name, a in arrs.items():
            if block.has_var(name) and block.var(name).dtype is not None:
                want = _np_dtype(block.var(name).dtype)
                if a.dtype != want:
                    arrs[name] = a.astype(want)
        return arrs

    def warmup(self, sample_feed=None):
        """Dispatch a one-row template (from ``sample_feed`` or the feed-var
        metadata) padded to every bucket, so every kernel has been built and
        run once before the first request. Returns the number of first
        dispatches it made (the reference's compile count: one per bucket
        on a fresh engine, 0 on a warmed one)."""
        if sample_feed is None:
            feed = self._template_feed()
        else:
            feed = self._normalize_dtypes(
                {k: np.asarray(v)[:1] for k, v in sample_feed.items()})
        before = sum(c.value for c in self._m_compiles.values())
        # the bundle's published tuning table loads BEFORE the first
        # dispatch: every warm executable's fingerprint carries its digest
        self._tune_table = _autotune.load_for_bundle(self._model_dir)
        with record_event("serving/warmup", kind="stage"), \
                _autotune.routing(self._tune_table):
            for b in self.buckets:
                if self._exec_cache is not None:
                    self._warm_bucket(feed, b)
                self._dispatch(feed, 1, b)
        self._warmed = True
        return int(sum(c.value for c in self._m_compiles.values()) - before)

    @staticmethod
    def _sig(padded, bucket, fetch_names):
        # the fetch names stay in order: a reordered fetch list is another
        # executable
        return (bucket, tuple(fetch_names),
                tuple(sorted((k, a.dtype.str, a.shape[1:])
                             for k, a in padded.items())))

    def _warm_bucket(self, feed, bucket):
        """Register one bucket's warm executable: load the artifact whose
        fingerprint matches this exact dispatch, or (writable caches)
        export and persist it. Every failure is silent: the bucket runs
        the op loop."""
        padded = {k: _pad_rows(np.asarray(a), bucket)
                  for k, a in feed.items()}
        sig = self._sig(padded, bucket, self._fetch_names)
        if sig in self._warm_execs:
            return
        entry = _execcache.acquire(
            self._exec_cache, self._bundle_hash, f"infer_b{bucket}",
            self._program, padded, self._fetch_names, self._exe,
            self._scope,
            identity={"instance": self.obs_instance, "bucket": bucket})
        if entry is not None:
            self._warm_execs[sig] = entry
            if entry.source == "cache":
                self._warm_loaded.add(sig)

    def infer(self, feed, fetch_list=None):
        """Run one batch; returns the fetch arrays trimmed to the true row
        count. Batches larger than the biggest bucket are chunked through
        it and the per-chunk results concatenated."""
        fetch_names = self._fetch_names if fetch_list is None else \
            [v if isinstance(v, str) else v.name for v in fetch_list]
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"infer feed is missing vars {missing}; "
                             f"the model feeds {self._feed_names}")
        arrs = self._normalize_dtypes(
            {n: np.asarray(feed[n]) for n in self._feed_names})
        ns = {a.shape[0] if a.ndim else 0 for a in arrs.values()}
        if len(ns) != 1:
            raise ValueError(
                f"inconsistent batch sizes across feeds: "
                f"{ {n: a.shape for n, a in arrs.items()} }")
        n = ns.pop()
        if n == 0:
            raise ValueError("cannot infer an empty batch")
        if n <= self.max_batch:
            return self._dispatch(arrs, n, self.bucket_for(n), fetch_names)
        parts = []
        for lo in range(0, n, self.max_batch):
            chunk = {k: a[lo:lo + self.max_batch] for k, a in arrs.items()}
            cn = min(self.max_batch, n - lo)
            parts.append(self._dispatch(chunk, cn, self.bucket_for(cn),
                                        fetch_names))
        return [_concat_rows([p[i] for p in parts])
                for i in range(len(fetch_names))]

    def _dispatch(self, arrs, n, bucket, fetch_names=None):
        fetch_names = fetch_names or self._fetch_names
        padded = {k: _pad_rows(a, bucket) for k, a in arrs.items()}
        sig = self._sig(padded, bucket, fetch_names)
        warm = self._warm_execs.get(sig)
        # accounting before the dispatch: a first dispatch through a
        # LOADED executable builds nothing and counts as a hit
        first = False
        with self._stats_lock:
            if sig in self._seen:
                self._m_hits[bucket].inc()
            else:
                self._seen.add(sig)
                if warm is not None and sig in self._warm_loaded:
                    self._m_hits[bucket].inc()
                else:
                    first = True
                    self._m_compiles[bucket].inc()
                    if self._warmed:
                        self._m_hot.inc()
        with self._lock, _autotune.routing(self._tune_table):
            outs = None
            if warm is not None:
                try:
                    with record_event(f"serving/infer_b{bucket}",
                                      kind="stage"):
                        outs = warm.run(self._exe, self._program, padded)
                except Exception as e:
                    # an executable that loaded but will not run: reject
                    # it and run the op loop, on this device and route
                    self._warm_execs.pop(sig, None)
                    loaded = sig in self._warm_loaded
                    self._warm_loaded.discard(sig)
                    self._exec_cache.note_reject(f"infer_b{bucket}",
                                                 "run_failed", error=e)
                    if loaded:
                        with self._stats_lock:
                            first = True
                            self._m_compiles[bucket].inc()
                            if self._warmed:
                                self._m_hot.inc()
            if outs is None:
                t0 = time.perf_counter()
                with record_event(f"serving/infer_b{bucket}", kind="stage"):
                    outs = self._exe.run(self._program, feed=padded,
                                         fetch_list=list(fetch_names),
                                         scope=self._scope)
                if first:
                    detail = dict(instance=self.obs_instance, bucket=bucket)
                    if self._exec_cache is not None:
                        detail["cache_hit"] = False
                    _perf.note_compile(
                        "engine_infer" if self._warmed else "engine_warmup",
                        time.perf_counter() - t0, identity=detail)
        trimmed = []
        for name, o in zip(fetch_names, outs):
            if isinstance(o, LoDArray) and o.lod_level == 1 \
                    and o.data.shape[0] == bucket:
                trimmed.append(LoDArray(o.data[:n], o.lens[:n]))
                continue
            if not isinstance(o, LoDArray) and o.ndim >= 1 \
                    and o.shape[0] == bucket:
                trimmed.append(o[:n])
                continue
            # a fetch without a leading batch dim was computed over the
            # padding rows: reject the model configuration loudly instead of
            # serving wrong answers (reference engine.py:433)
            raise ValueError(
                f"fetch {name!r} is not per-row (shape "
                f"{getattr(o, 'shape', None)}, bucket "
                f"{bucket}): serving requires every fetch to carry a "
                "leading batch dimension — batch-reduced outputs (means, "
                "aggregate metrics) cannot be padded or split per caller")
        return trimmed

    def release(self):
        """Drop this engine's parameters (its private scope), so a model
        the ModelServer's LRU evicts gives its memory back with the last
        reference. The engine is done serving afterwards: call only after
        its final in-flight dispatch finished."""
        with self._lock:
            self._warm_execs.clear()
            self._warm_loaded.clear()
            self._scope = Scope()
            self._warmed = False

    def _memory_section(self):
        """Bytes this engine can explain (its scope's parameter tensors)
        beside the live bytes of its device (obs.perf's sample: the CUDA
        allocator's on a card, the process's resident set on the CPU)."""
        param_bytes = 0
        for name in self._scope.local_names():
            v = self._scope.find_var(name)
            if hasattr(v, "element_size"):
                param_bytes += v.numel() * v.element_size()
            elif hasattr(v, "nbytes"):
                param_bytes += int(v.nbytes)
        mem = _perf.sample_device_memory()
        dev = self.device
        label = f"cuda:{dev.index or 0}" if dev.type == "cuda" else "cpu:0"
        live = mem["devices"].get(label)
        return {"param_bytes": int(param_bytes),
                "device_bytes_live": live,
                "source": mem["sources"].get(label),
                "unaccounted_bytes": None if live is None
                else max(0, live - int(param_bytes))}

    def tune_digest(self):
        """Digest of the tuning table this engine's dispatches route by
        (its bundle's, else the one attached process-wide), or None."""
        with _autotune.routing(self._tune_table):
            return _autotune.active_digest()

    def stats(self):
        """The reference's keys (buckets, per-bucket compiles and hits,
        their totals, hot_recompiles, warmed, kernel_tier, tune_digest,
        exec_cache, warm_loaded, memory) beside
        the port's dispatch counts (compiles + hits), the process-wide
        conv_affine launches and fallbacks. JSON-safe: it crosses the RPC
        wire."""
        with self._stats_lock:
            per_bucket = {}
            for b in self.buckets:
                c = int(self._m_compiles[b].value)
                h = int(self._m_hits[b].value)
                per_bucket[b] = {"dispatches": c + h, "compiles": c,
                                 "hits": h}
        return json_safe({
            "buckets": list(self.buckets),
            "per_bucket": per_bucket,
            "dispatches": sum(s["dispatches"] for s in per_bucket.values()),
            "compiles": sum(s["compiles"] for s in per_bucket.values()),
            "hits": sum(s["hits"] for s in per_bucket.values()),
            "hot_recompiles": self.hot_recompiles,
            "warmed": self._warmed,
            "kernel_tier": kernel_tier.resolve_tier(self.device),
            "tune_digest": self.tune_digest(),
            "exec_cache": self._exec_cache.stats()
            if self._exec_cache is not None else None,
            "warm_loaded": len(self._warm_loaded),
            "kernel_launches": {
                "conv_affine": conv_bn.launches["conv_affine"],
                "conv_affine_db": conv_bn.launches["conv_affine_db"]},
            "fallbacks": kernel_tier.fallback_counts(),
            "memory": self._memory_section(),
        })


def _np_dtype(name):
    """Host dtype for a feed var (bfloat16 feeds travel as float32; the
    executor casts them on the device)."""
    name = convert_dtype(name)
    return np.dtype("float32" if name == "bfloat16" else name)


__all__ = ["InferenceEngine", "parse_buckets"]
