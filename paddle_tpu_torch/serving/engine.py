"""InferenceEngine: bucket-padded execution of a saved inference program
(counterpart of paddle_tpu/serving/engine.py:118).

The engine pads each incoming batch up to a small fixed set of batch
buckets (the ``serving_batch_buckets`` flag), chunks batches beyond the
largest bucket through it, and trims every fetch back to the true row count.
Padding rows replicate the batch's last row, which is inert for any per-row
model. The reference pads so each bucket compiles once; this port runs
eagerly, so the same buckets bound the set of shapes the kernels see, and
the engine counts dispatches per bucket where the reference counts compiles.
"""

from __future__ import annotations

import bisect
import threading

import numpy as np

from ..core.executor import Executor
from ..core.flags import get_flag
from ..core.scope import Scope
from ..core.types import convert_dtype
from ..fluid import io as fluid_io
from ..ops import cuda as kernel_tier
from ..ops.cuda import conv_bn


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


def _pad_rows(a, bucket):
    """Pad a [n, ...] array up to [bucket, ...] by replicating its last
    row (outputs for the padding rows are discarded by the caller)."""
    pad = bucket - a.shape[0]
    if pad <= 0:
        return a
    return np.concatenate(
        [a, np.broadcast_to(a[-1:], (pad,) + a.shape[1:])], axis=0)


class InferenceEngine:
    """Bucket-padded executor for one saved inference model::

        engine = InferenceEngine(model_dir)                 # on cuda:0
        engine = InferenceEngine(model_dir, place=fluid.CPUPlace())

    The engine loads the bundle's persistables into its OWN private scope,
    so many engines coexist in one process. :meth:`infer` serializes
    dispatches with a lock.
    """

    def __init__(self, model_dir, place=None, buckets=None):
        self._scope = Scope()
        self._exe = Executor(place)
        program, feed_names, fetch_vars = fluid_io.load_inference_model(
            model_dir, self._exe, scope=self._scope)
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = [v if isinstance(v, str) else v.name
                             for v in fetch_vars]
        self.buckets = parse_buckets(buckets)
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._dispatches = {b: 0 for b in self.buckets}
        self._warmed = False

    @property
    def program(self):
        return self._program

    @property
    def device(self):
        return self._exe.device

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
        run once before the first request. Returns the number of buckets
        dispatched."""
        if sample_feed is None:
            feed = self._template_feed()
        else:
            feed = self._normalize_dtypes(
                {k: np.asarray(v)[:1] for k, v in sample_feed.items()})
        for b in self.buckets:
            self._dispatch(feed, 1, b)
        self._warmed = True
        return len(self.buckets)

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
        return [np.concatenate([p[i] for p in parts], axis=0)
                for i in range(len(fetch_names))]

    def _dispatch(self, arrs, n, bucket, fetch_names=None):
        fetch_names = fetch_names or self._fetch_names
        padded = {k: _pad_rows(a, bucket) for k, a in arrs.items()}
        with self._stats_lock:
            self._dispatches[bucket] += 1
        with self._lock:
            outs = self._exe.run(self._program, feed=padded,
                                 fetch_list=list(fetch_names),
                                 scope=self._scope)
        trimmed = []
        for name, o in zip(fetch_names, outs):
            if o.ndim >= 1 and o.shape[0] == bucket:
                trimmed.append(o[:n])
                continue
            # a fetch without a leading batch dim was computed over the
            # padding rows: reject the model configuration loudly instead of
            # serving wrong answers (reference engine.py:433)
            raise ValueError(
                f"fetch {name!r} is not per-row (shape {o.shape}, bucket "
                f"{bucket}): serving requires every fetch to carry a "
                "leading batch dimension — batch-reduced outputs (means, "
                "aggregate metrics) cannot be padded or split per caller")
        return trimmed

    def stats(self):
        """Buckets, per-bucket dispatch counts, the kernel route this
        engine's device resolves to, and the process-wide kernel launch and
        fallback counts."""
        with self._stats_lock:
            per_bucket = {b: {"dispatches": d}
                          for b, d in self._dispatches.items()}
        return {
            "buckets": list(self.buckets),
            "per_bucket": per_bucket,
            "dispatches": sum(s["dispatches"] for s in per_bucket.values()),
            "warmed": self._warmed,
            "kernel_tier": kernel_tier.resolve_tier(self.device),
            "kernel_launches": {
                "conv_affine": conv_bn.launches["conv_affine"]},
            "fallbacks": kernel_tier.fallback_counts(),
        }


def _np_dtype(name):
    """Host dtype for a feed var (bfloat16 feeds travel as float32; the
    executor casts them on the device)."""
    name = convert_dtype(name)
    return np.dtype("float32" if name == "bfloat16" else name)


__all__ = ["InferenceEngine", "parse_buckets"]
