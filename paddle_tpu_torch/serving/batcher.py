"""DynamicBatcher: coalesce concurrent requests into bucket-sized batches
(counterpart of paddle_tpu/serving/batcher.py, ported whole: it is pure
Python over numpy).

N concurrent small requests cost N engine dispatches unbatched but one
coalesced, and on the card a dispatch has a fixed host cost (the
executor's walk of the program, a few hundred kernel launches) that the
row count barely moves. The batcher holds a bounded queue; a worker
thread groups whole requests into a batch of up to ``max_batch`` rows,
waiting at most ``max_delay_ms`` for stragglers (a full batch dispatches
at once), runs the batch through the engine, and splits the fetches back
per caller. Only requests of the same feed names, dtypes and trailing
shapes share a batch.

Backpressure is the bounded queue: when ``capacity`` requests already
wait, :meth:`DynamicBatcher.submit` rejects fast with the typed
:class:`ServerOverloaded`. :class:`TenantQuotas` holds per-tenant token
buckets and rejects typed with :class:`QuotaExceeded`. The generation
scheduler raises ``ServerOverloaded`` from here too.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque

import numpy as np

from ..core.flags import get_flag
from ..obs.metrics import REGISTRY as _METRICS, json_safe, next_instance
from ..obs.recorder import record as _flight_record

_M_REQUESTS = _METRICS.counter(
    "paddle_tpu_batcher_requests",
    "requests submitted to a DynamicBatcher, per instance",
    labels=("instance",))
_M_REJECTED = _METRICS.counter(
    "paddle_tpu_batcher_rejected",
    "requests rejected with ServerOverloaded (queue full), per instance",
    labels=("instance",))
_M_BATCHES = _METRICS.counter(
    "paddle_tpu_batcher_batches",
    "coalesced batches dispatched by a DynamicBatcher, per instance",
    labels=("instance",))
_M_QUEUE_DEPTH = _METRICS.gauge(
    "paddle_tpu_server_queue_depth",
    "requests currently waiting in a serving queue (DynamicBatcher or "
    "ContinuousBatcher), per instance — updated on every enqueue/dequeue "
    "so scrapes and fleet_metrics() read it O(1)",
    labels=("instance",))
_M_TENANT_REQUESTS = _METRICS.counter(
    "paddle_tpu_tenant_requests",
    "requests checked against a TenantQuotas bucket, by quota instance "
    "and (capped, funneled) tenant label",
    labels=("instance", "tenant"))
_M_TENANT_REJECTED = _METRICS.counter(
    "paddle_tpu_tenant_rejected",
    "requests rejected with QuotaExceeded (tenant token bucket empty), "
    "by quota instance and (capped, funneled) tenant label",
    labels=("instance", "tenant"))


class ServerOverloaded(RuntimeError):
    """The serving queue is full: reject-fast backpressure. Clients should
    back off (bounded exponential delay) and retry or shed the request —
    InferClient re-raises this type from the remote error string."""


class QuotaExceeded(RuntimeError):
    """A tenant's token-bucket quota is exhausted: the request is over
    budget EVERYWHERE, so — unlike :class:`ServerOverloaded` — routers
    must surface it without failover or spillover (another replica would
    reject it identically). Carried over the wire as a structured code and
    re-raised typed by the clients (see serving/client.py)."""

    def __init__(self, message, tenant=None, retry_after_s=None):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


_TENANT_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_\-]*$")


class TenantQuotas:
    """Per-tenant token buckets: each tenant accrues ``rate`` tokens per
    second up to a ``burst`` ceiling; a request spends one token or is
    rejected typed with :class:`QuotaExceeded` carrying the refill ETA.

    ``rate``/``burst`` default from the ``serving_tenant_rate`` /
    ``serving_tenant_burst`` flags (rate <= 0 means UNLIMITED — every
    tenant admits unless it has an explicit override). ``overrides`` maps
    tenant name -> (rate, burst) for per-tenant budgets; an override rate
    <= 0 makes that one tenant unlimited.

    Tenant ids arrive off the WIRE, so the registry mirror funnels them
    exactly like RPC method names: past ``serving_tenant_label_cap``
    distinct tenants (or a non-identifier name) the per-tenant series
    label collapses to ``__other__`` — a misbehaving caller inventing
    tenant ids must never grow scrape-visible cardinality without bound.
    ``stats()`` keeps the exact per-tenant view (it dies with the
    instance)."""

    def __init__(self, rate=None, burst=None, overrides=None,
                 label_cap=None):
        self.rate = float(get_flag("serving_tenant_rate")
                          if rate is None else rate)
        burst = int(get_flag("serving_tenant_burst")
                    if burst is None else burst)
        self.burst = burst if burst > 0 else max(1, int(math.ceil(
            self.rate if self.rate > 0 else 1)))
        self.overrides = {}
        for tenant, spec in (overrides or {}).items():
            r, b = spec
            r = float(r)
            b = int(b) if int(b) > 0 else max(1, int(math.ceil(
                r if r > 0 else 1)))
            self.overrides[str(tenant)] = (r, b)
        self._label_cap = int(get_flag("serving_tenant_label_cap")
                              if label_cap is None else label_cap)
        self._lock = threading.Lock()
        self._buckets = {}    # tenant -> [tokens, last_refill_monotonic]
        self._rejected = {}   # tenant -> exact reject count
        self._admitted = {}   # tenant -> exact admit count
        self.obs_instance = next_instance("quotas")
        self._m_tenant = {}   # tenant -> (requests child, rejected child)

    # ------------------------------------------------------------------
    def _limits(self, tenant):
        return self.overrides.get(tenant, (self.rate, self.burst))

    def _metric_children_locked(self, tenant):
        mc = self._m_tenant.get(tenant)
        if mc is None:
            label = tenant if _TENANT_NAME_RE.match(tenant) \
                and len(self._m_tenant) < self._label_cap else "__other__"
            mc = self._m_tenant[tenant] = (
                _M_TENANT_REQUESTS.labels(instance=self.obs_instance,
                                          tenant=label),
                _M_TENANT_REJECTED.labels(instance=self.obs_instance,
                                          tenant=label))
        return mc

    def try_acquire(self, tenant, now=None):
        """Spend one token from ``tenant``'s bucket. Returns
        ``(admitted, retry_after_s)`` — ``retry_after_s`` is the time
        until one token refills when rejected, else 0.0."""
        tenant = str(tenant)
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            m_req, m_rej = self._metric_children_locked(tenant)
            rate, burst = self._limits(tenant)
            if rate <= 0:
                self._admitted[tenant] = self._admitted.get(tenant, 0) + 1
                admitted, retry = True, 0.0
            else:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = [float(burst), now]
                tokens, last = bucket
                tokens = min(float(burst), tokens + (now - last) * rate)
                bucket[1] = now
                if tokens >= 1.0:
                    bucket[0] = tokens - 1.0
                    self._admitted[tenant] = \
                        self._admitted.get(tenant, 0) + 1
                    admitted, retry = True, 0.0
                else:
                    bucket[0] = tokens
                    self._rejected[tenant] = \
                        self._rejected.get(tenant, 0) + 1
                    admitted, retry = False, (1.0 - tokens) / rate
        m_req.inc()
        if not admitted:
            m_rej.inc()
            _flight_record("quota_reject", component=self.obs_instance,
                           tenant=tenant, retry_after_s=round(retry, 6))
        return admitted, retry

    def check(self, tenant):
        """:meth:`try_acquire`, raising typed :class:`QuotaExceeded` on
        rejection (the enforcement form servers and routers call)."""
        admitted, retry = self.try_acquire(tenant)
        if not admitted:
            raise QuotaExceeded(
                f"tenant {tenant!r} is over its request quota; retry "
                f"after {retry:.3f}s", tenant=tenant, retry_after_s=retry)

    def stats(self):
        with self._lock:
            tenants = sorted(set(self._admitted) | set(self._rejected))
            out = {
                "rate": self.rate,
                "burst": self.burst,
                "overrides": {t: {"rate": r, "burst": b}
                              for t, (r, b) in self.overrides.items()},
                "tenants": {t: {"admitted": self._admitted.get(t, 0),
                                "rejected": self._rejected.get(t, 0)}
                            for t in tenants},
            }
        return json_safe(out)


class _Request:
    __slots__ = ("feed", "n", "sig", "done", "result", "error")

    def __init__(self, feed, n):
        self.feed = feed
        self.n = n
        # coalesce-compatibility signature: requests only batch with
        # requests of the same feed names, dtypes and trailing shapes —
        # one malformed request (float64 from numpy's default, a wrong
        # feature dim) must fail ALONE, not upcast/except the whole batch
        self.sig = tuple(sorted(
            (k, np.asarray(v).dtype.str, np.asarray(v).shape[1:])
            for k, v in feed.items()))
        self.done = threading.Event()
        self.result = None
        self.error = None


class DynamicBatcher:
    """``run_batch`` is the batch executor — ``InferenceEngine.infer``'s
    signature: feed dict of [n, ...] arrays in, list of fetch arrays
    (leading dim n) out. ``max_batch`` is the coalesce target (the
    engine's largest bucket); ``max_delay_ms``/``capacity`` default from
    the ``serving_max_delay_ms``/``serving_queue_capacity`` flags."""

    def __init__(self, run_batch, max_batch, max_delay_ms=None,
                 capacity=None):
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        if max_delay_ms is None:
            max_delay_ms = get_flag("serving_max_delay_ms")
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.capacity = int(get_flag("serving_queue_capacity")
                            if capacity is None else capacity)
        self._pending = deque()
        self._cv = threading.Condition()
        self._closed = False
        # request/reject/batch counters live in the obs.metrics registry
        # under this batcher's instance label (stats() derives from them);
        # the per-batch-size histogram stays local (under _cv)
        self.obs_instance = next_instance("batcher")
        self._m_requests = _M_REQUESTS.labels(instance=self.obs_instance)
        self._m_rejected = _M_REJECTED.labels(instance=self.obs_instance)
        self._m_batches = _M_BATCHES.labels(instance=self.obs_instance)
        self._m_depth = _M_QUEUE_DEPTH.labels(instance=self.obs_instance)
        self._m_depth.set(0)
        self._batch_hist = {}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, feed):
        """Block until this request's rows come back from a coalesced
        batch; raises :class:`ServerOverloaded` immediately when the queue
        is full (never queues past ``capacity``)."""
        if not feed:
            raise ValueError("cannot submit an empty feed")
        ns = {np.asarray(v).shape[0] if np.ndim(v) else 1
              for v in feed.values()}
        if len(ns) != 1:
            # reject the malformed request HERE: coalesced with others it
            # would fail the engine's row-count check for the whole batch
            raise ValueError(
                f"inconsistent batch sizes across feeds: "
                f"{ {k: np.asarray(v).shape for k, v in feed.items()} }")
        n = int(ns.pop())
        if n == 0:
            # alone it would raise the engine's empty-batch error anyway;
            # coalesced it would silently return empty arrays — reject
            # deterministically instead of traffic-dependently
            raise ValueError("cannot submit an empty (0-row) batch")
        req = _Request(feed, n)
        with self._cv:
            if self._closed:
                raise RuntimeError("DynamicBatcher is closed")
            self._m_requests.inc()
            if len(self._pending) >= self.capacity:
                self._m_rejected.inc()
                _flight_record("overload_reject",
                               component=self.obs_instance,
                               queue_depth=len(self._pending),
                               capacity=self.capacity)
                raise ServerOverloaded(
                    f"serving queue full ({self.capacity} requests "
                    "waiting); back off and retry")
            self._pending.append(req)
            self._m_depth.set(len(self._pending))
            self._cv.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------------
    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                # coalesce: hold the batch open for stragglers until the
                # deadline, but dispatch a full batch (or a closing
                # batcher's flush) immediately
                deadline = time.monotonic() + self.max_delay_s
                while (sum(r.n for r in self._pending) < self.max_batch
                       and not self._closed):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left)
                batch = [self._pending.popleft()]
                total = batch[0].n
                while self._pending and \
                        total + self._pending[0].n <= self.max_batch and \
                        self._pending[0].sig == batch[0].sig:
                    # an incompatible head ends the batch and forms its
                    # own on the next loop turn (FIFO preserved)
                    r = self._pending.popleft()
                    batch.append(r)
                    total += r.n
                self._m_depth.set(len(self._pending))
                self._m_batches.inc()
                self._batch_hist[total] = \
                    self._batch_hist.get(total, 0) + 1
            self._dispatch(batch, total)

    def _dispatch(self, batch, total):
        """Run one coalesced batch OUTSIDE the queue lock and route the
        fetch rows back to their callers (an error fans out to every
        caller in the batch)."""
        try:
            if len(batch) == 1:
                feed = batch[0].feed
            else:
                feed = {k: np.concatenate(
                            [np.asarray(r.feed[k]) for r in batch], axis=0)
                        for k in batch[0].feed}
            fetches = self._run_batch(feed)
            for f in fetches:
                if not (isinstance(f, np.ndarray) and f.ndim >= 1
                        and f.shape[0] == total):
                    # a non-per-row fetch cannot be split back per caller
                    # — it was computed over the COALESCED rows of every
                    # request in this batch (the engine enforces the same
                    # contract; this guards foreign run_batch callables)
                    raise ValueError(
                        f"run_batch returned a non-per-row fetch (shape "
                        f"{getattr(f, 'shape', None)}, batch rows {total})"
                        "; dynamic batching requires fetches with a "
                        "leading batch dimension")
            lo = 0
            for r in batch:
                r.result = [f[lo:lo + r.n] for f in fetches]
                lo += r.n
        except Exception as e:
            for r in batch:
                r.error = e
        finally:
            for r in batch:
                r.done.set()

    # ------------------------------------------------------------------
    def stats(self):
        with self._cv:
            depth = len(self._pending)
            hist = dict(sorted(self._batch_hist.items()))
        # counters derived from this instance's obs.metrics children
        return json_safe({
            "queue_depth": depth,
            "capacity": self.capacity,
            "max_batch": self.max_batch,
            "max_delay_ms": self.max_delay_s * 1e3,
            "requests": int(self._m_requests.value),
            "rejected": int(self._m_rejected.value),
            "batches": int(self._m_batches.value),
            "batch_size_hist": hist,
        })

    def close(self, timeout=30.0):
        """Stop admitting requests, FLUSH everything already queued (their
        callers get real results), and join the worker. If the worker is
        WEDGED (a run_batch that never returns) and the join times out,
        requests still waiting in the queue are rejected with a typed
        RuntimeError instead of hanging their callers forever — a queued
        request at close() is always either answered or rejected typed.
        Returns True when the worker exited within ``timeout``."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout)
        closed_clean = not self._worker.is_alive()
        if not closed_clean:
            # pop the undispatched queue under the lock so the wedged
            # worker can never race these requests back out of it
            with self._cv:
                stranded, self._pending = list(self._pending), deque()
                self._m_depth.set(0)
            err = RuntimeError(
                "DynamicBatcher is closed: the dispatch worker did not "
                f"exit within {timeout}s (wedged run_batch); this queued "
                "request was rejected without being served")
            for r in stranded:
                r.error = err
                r.done.set()
        return closed_clean


__all__ = ["DynamicBatcher", "QuotaExceeded", "ServerOverloaded",
           "TenantQuotas"]
