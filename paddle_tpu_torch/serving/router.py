"""FleetClient: a client-side load balancer over a replica fleet
(counterpart of paddle_tpu/serving/router.py, ported whole: it is host
code over the port's InferClient and RetryPolicy).

The routing layer the reference delegated to an external LB sits client-
side here (the gRPC "thick client" pattern): pick a replica by
power-of-two-choices over in-flight counts, fail an idempotent ``infer``
over to a DIFFERENT replica on connection failure, spill a typed
``ServerOverloaded`` to the next replica before surfacing it, and keep a
health view of the fleet — a replica that fails is EJECTED from the pick
set and re-admitted only after a probation of consecutive successful
background health probes (flapping replicas don't bounce in and out on a
single lucky probe).

Error taxonomy (what moves where):

* connection failure (EOF mid-call, refused connect — a crashed or
  restarting replica) — eject the replica, fail over to another; when a
  whole sweep of the fleet fails this way, back off under the
  ``rpc.RetryPolicy`` and sweep again (infer is stateless/idempotent, so
  resending is always safe).
* :class:`~.batcher.ServerOverloaded` (structured code over the wire) —
  the replica is alive but saturated: NOT an ejection (health is fine),
  just spill to the next replica; only when every available replica is
  overloaded does the caller see the typed overload (never auto-retried —
  retrying into a saturated fleet spreads collapse).
* response timeout — ambiguous (the request may be executing), surfaced
  to the caller like every other client in this codebase.
* :class:`~.batcher.QuotaExceeded` — the TENANT is over budget, not the
  replica: deterministic everywhere, so surfaced typed with NO failover
  and NO spillover (spilling an over-quota request to the next replica
  would just burn a connection to be rejected identically). Enforced
  router-side first (``quotas=``) — a locally rejected request never
  even picks a replica — and re-raised typed when a server-side bucket
  rejects over the wire.
* remote errors (``rpc.RemoteError``) — deterministic (a bad feed fails
  identically on every replica): surfaced, no failover.
"""

from __future__ import annotations

import random
import threading
import time

from ..core.flags import get_flag
from ..core.profiler import trace_context
from ..distributed.rpc import RetryPolicy, RpcClient
from ..obs import recorder as _flight
from ..obs.metrics import REGISTRY as _METRICS, json_safe, next_instance
from .batcher import QuotaExceeded, ServerOverloaded
from .client import InferClient

_CONN_ERRORS = (EOFError, ConnectionError, BrokenPipeError, OSError)

_M_REQUESTS = _METRICS.counter(
    "paddle_tpu_router_requests",
    "requests routed through a FleetClient, per instance",
    labels=("instance",))
_M_FAILOVERS = _METRICS.counter(
    "paddle_tpu_router_failovers",
    "connection-failure failovers to another replica, per instance",
    labels=("instance",))
_M_SPILLOVERS = _METRICS.counter(
    "paddle_tpu_router_spillovers",
    "ServerOverloaded spillovers to the next replica, per instance",
    labels=("instance",))
_M_EJECTIONS = _METRICS.counter(
    "paddle_tpu_router_ejections",
    "replicas ejected from the routing set, per instance",
    labels=("instance",))
_M_QUOTA_REJECTS = _METRICS.counter(
    "paddle_tpu_router_quota_rejects",
    "requests rejected typed with QuotaExceeded at a FleetClient "
    "(router-local bucket or a replica's over the wire) — never "
    "failovers, never spillovers; per instance",
    labels=("instance",))
_M_FLEET_SECONDS = _METRICS.histogram(
    "paddle_tpu_fleet_request_seconds",
    "FleetClient end-to-end request latency window, per instance",
    labels=("instance",), span_name="fleet/request", span_kind="rpc")


class _Replica:
    """Router-side view of one replica: a CONNECTION POOL (one RpcClient
    serializes its socket, so concurrent requests to the same replica
    each need their own connection — the pool's size tracks peak
    concurrency and idle connections are reused), the in-flight count,
    and the health/probation state (all mutated under the router lock)."""

    __slots__ = ("address", "timeout", "free", "inflight", "healthy",
                 "consec_ok", "ejections")

    def __init__(self, address, timeout):
        self.address = tuple(address)
        self.timeout = timeout
        self.free = []          # idle InferClients, LIFO (warm conn first)
        self.inflight = 0
        self.healthy = True
        self.consec_ok = 0
        self.ejections = 0

    def acquire_locked(self):
        """Check an idle connection out (caller holds the router lock) —
        or a fresh one; retry=None because the ROUTER owns failure
        policy: a per-connection retry would pin a request to a dead
        replica for the whole backoff budget instead of failing over."""
        if self.free:
            return self.free.pop()
        return InferClient(self.address, timeout=self.timeout, retry=None)

    def release_locked(self, client, broken):
        if broken:
            client.close()
        else:
            self.free.append(client)

    def close_all_locked(self):
        while self.free:
            self.free.pop().close()


class FleetClient:
    """``FleetClient(addresses)`` — balance infers over a replica set.

    ``retry`` (default a stock ``RetryPolicy``) bounds the full-fleet
    retry sweeps, NOT per-replica attempts; ``probe_interval_ms`` /
    ``probation_probes`` default from the ``serving_probe_interval_ms`` /
    ``serving_probation_probes`` flags."""

    def __init__(self, addresses, timeout=None, retry=True,
                 probe_interval_ms=None, probation_probes=None,
                 probe_timeout=2.0, quotas=None):
        if not addresses:
            raise ValueError("FleetClient needs at least one replica "
                             "address")
        if retry is True:
            retry = RetryPolicy()
        self._retry = retry or None
        # router-side tenant quotas (a batcher.TenantQuotas): enforced
        # BEFORE a replica is picked, so an over-budget request costs
        # zero fleet work and can never be mistaken for replica trouble
        self._quotas = quotas
        self._timeout = timeout
        self._replicas = [_Replica(a, timeout) for a in addresses]
        self._lock = threading.Lock()
        # router counters + latency window live in the obs.metrics
        # registry under this router's instance label
        self.obs_instance = next_instance("router")
        self.latency = _M_FLEET_SECONDS.labels(instance=self.obs_instance)
        self._m_requests = _M_REQUESTS.labels(instance=self.obs_instance)
        self._m_failovers = _M_FAILOVERS.labels(instance=self.obs_instance)
        self._m_spillovers = _M_SPILLOVERS.labels(
            instance=self.obs_instance)
        self._m_ejections = _M_EJECTIONS.labels(instance=self.obs_instance)
        self._m_quota_rejects = _M_QUOTA_REJECTS.labels(
            instance=self.obs_instance)
        if probe_interval_ms is None:
            probe_interval_ms = get_flag("serving_probe_interval_ms")
        self._probe_interval_s = float(probe_interval_ms) / 1e3
        if probation_probes is None:
            probation_probes = get_flag("serving_probation_probes")
        self._probation = max(1, int(probation_probes))
        self._probe_timeout = float(probe_timeout)
        self._stop = threading.Event()
        self._prober = threading.Thread(target=self._probe_loop,
                                        daemon=True)
        self._prober.start()

    # ------------------------------------------------------------------
    def add_replica(self, address):
        """Join ``address`` to the routing set (the autoscaler's
        scale-out hand-off: a spawned replica serves no traffic until
        some router routes to it). Idempotent — re-adding a member is a
        no-op. Returns True when the set grew."""
        address = (str(address[0]), int(address[1]))
        with self._lock:
            if any(r.address == address for r in self._replicas):
                return False
            self._replicas.append(_Replica(address, self._timeout))
        return True

    def remove_replica(self, address):
        """Drop ``address`` from the routing set (scale-in), closing its
        pooled connections; in-flight requests on it finish normally.
        Refuses to empty the set. Returns True when a member was
        removed."""
        address = (str(address[0]), int(address[1]))
        with self._lock:
            keep = [r for r in self._replicas if r.address != address]
            if len(keep) == len(self._replicas):
                return False
            if not keep:
                raise ValueError("cannot remove the last replica "
                                 f"{address[0]}:{address[1]}")
            for r in self._replicas:
                if r.address == address:
                    r.close_all_locked()
            self._replicas = keep
        return True

    def _pick(self, tried):
        """Power-of-two-choices over in-flight counts, healthy replicas
        first; falls back to ejected ones (a refused connect is cheap and
        beats stalling when the prober lags a restart). None when every
        replica was tried this sweep."""
        with self._lock:
            pool = [r for r in self._replicas
                    if r.healthy and id(r) not in tried]
            if not pool:
                pool = [r for r in self._replicas if id(r) not in tried]
            if not pool:
                return None
            if len(pool) == 1:
                r = pool[0]
            else:
                a, b = random.sample(pool, 2)
                r = a if a.inflight <= b.inflight else b
            r.inflight += 1
            return r

    def _release(self, r, client, broken):
        with self._lock:
            r.inflight -= 1
            r.release_locked(client, broken)

    def _eject(self, r):
        with self._lock:
            self._m_failovers.inc()
            ejected = False
            if r.healthy:
                r.healthy = False
                r.ejections += 1
                self._m_ejections.inc()
                ejected = True
            r.consec_ok = 0
            # pooled idle connections point at the dead incarnation; drop
            # them so a re-admitted replica starts on fresh sockets
            r.close_all_locked()
        # flight recorder: the routing DECISION (called inside the
        # request's trace context, so the event joins its track); one
        # event per failover, the ejection flagged on the first
        _flight.record("failover", component=self.obs_instance,
                       replica=f"{r.address[0]}:{r.address[1]}",
                       ejected=ejected)

    # ------------------------------------------------------------------
    def infer(self, feed, model=None, tenant=None):
        """One request through the fleet. Raises ``ServerOverloaded``
        only when every available replica rejected it, connection errors
        only when the whole fleet stayed unreachable through the retry
        budget, and ``QuotaExceeded`` immediately when ``tenant`` is
        over budget (no failover, no spillover — see module docstring).
        ``model=`` routes to a named hosted model on multi-model
        replicas."""
        self._m_requests.inc()
        if self._quotas is not None and tenant is not None:
            try:
                self._quotas.check(tenant)
            except QuotaExceeded:
                self._m_quota_rejects.inc()
                raise
        # ONE trace id for the whole fleet request: every failover /
        # spillover attempt below reuses it (the per-attempt InferClient
        # calls pick it up from the context), so the merged chrome trace
        # shows the request as one connected track across replicas
        with trace_context(), self.latency.span():
            attempt = 0
            while True:
                overload = None
                conn_err = None
                tried = set()
                while True:
                    r = self._pick(tried)
                    if r is None:
                        break
                    tried.add(id(r))
                    with self._lock:
                        client = r.acquire_locked()
                    broken = True    # returned to the pool only on success
                    try:
                        out = client.infer(feed, model=model,
                                           tenant=tenant)
                        broken = False
                        return out
                    except QuotaExceeded:
                        # a replica-side bucket rejected: deterministic
                        # for this tenant everywhere — surface typed,
                        # conn back to the pool, NO failover/spillover
                        broken = False
                        self._m_quota_rejects.inc()
                        _flight.record(
                            "quota_reject", component=self.obs_instance,
                            tenant=tenant,
                            replica=f"{r.address[0]}:{r.address[1]}")
                        raise
                    except ServerOverloaded as e:
                        self._m_spillovers.inc()
                        _flight.record(
                            "spillover", component=self.obs_instance,
                            replica=f"{r.address[0]}:{r.address[1]}")
                        broken = False   # replica alive; conn still good
                        overload = e
                    except TimeoutError:
                        raise        # ambiguous: may be executing; surface
                    except _CONN_ERRORS as e:
                        self._eject(r)
                        conn_err = e
                    finally:
                        self._release(r, client, broken)
                if overload is not None:
                    # every reachable replica is saturated: typed overload,
                    # never auto-retried (see module docstring)
                    raise overload
                if conn_err is None:
                    raise ConnectionError("fleet has no replicas to try")
                if self._retry is None \
                        or attempt >= self._retry.max_retries:
                    raise conn_err
                attempt += 1
                # the retry DECISION: a whole-fleet sweep failed and the
                # request is backing off for another — recorded so an
                # incident bundle shows how long a request chased a
                # restarting fleet
                _flight.record("retry_sweep", component=self.obs_instance,
                               attempt=attempt,
                               error=type(conn_err).__name__)
                time.sleep(self._retry.delay_s(attempt))

    # ------------------------------------------------------------------
    def _probe_loop(self):
        """Background health probes for EJECTED replicas: ``_probation``
        consecutive successes re-admit (one fluke doesn't); any failure
        resets the streak. Healthy replicas are not probed — real traffic
        is their probe."""
        while not self._stop.wait(self._probe_interval_s):
            for r in self._replicas:
                if r.healthy or self._stop.is_set():
                    continue
                ok = False
                try:
                    c = RpcClient(r.address, timeout=self._probe_timeout)
                    try:
                        h = c.call("health")
                        ok = (h.get("status") == "serving"
                              and bool(h.get("warmed", True)))
                    finally:
                        c.close()
                except Exception:
                    ok = False
                with self._lock:
                    if ok:
                        r.consec_ok += 1
                        if r.consec_ok >= self._probation:
                            r.healthy = True
                    else:
                        r.consec_ok = 0

    # ------------------------------------------------------------------
    def fleet_stats(self, include_server_stats=True):
        """Aggregate view: per-replica health/in-flight/ejections (plus
        each reachable replica's full server stats), router counters, and
        client-observed latency percentiles."""
        with self._lock:
            reps = [{"address": f"{r.address[0]}:{r.address[1]}",
                     "healthy": r.healthy, "inflight": r.inflight,
                     "ejections": r.ejections} for r in self._replicas]
        counters = {"requests": int(self._m_requests.value),
                    "failovers": int(self._m_failovers.value),
                    "spillovers": int(self._m_spillovers.value),
                    "ejections": int(self._m_ejections.value),
                    "quota_rejects": int(self._m_quota_rejects.value)}
        if self._quotas is not None:
            counters["quotas"] = self._quotas.stats()
        engine = {"compiles": 0, "hits": 0, "hot_recompiles": 0}
        versions = set()
        if include_server_stats:
            for entry, r in zip(reps, self._replicas):
                try:
                    c = RpcClient(r.address, timeout=self._probe_timeout)
                    try:
                        st = c.call("stats")
                    finally:
                        c.close()
                except Exception:
                    st = None
                entry["server"] = st
                if st is not None:
                    for k in engine:
                        engine[k] += st.get("engine", {}).get(k, 0)
                    versions.add(st.get("version"))
        lat = self.latency.snapshot()
        out = {"replicas": reps,
               "healthy": sum(1 for e in reps if e["healthy"]),
               "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"]}
        out.update(counters)
        if include_server_stats:
            out["engine"] = engine
            out["versions"] = sorted(versions,
                                     key=lambda v: (v is None, v))
        return json_safe(out)

    def close(self):
        self._stop.set()
        self._prober.join(self._probe_interval_s * 4
                          + self._probe_timeout + 1.0)
        with self._lock:
            for r in self._replicas:
                r.close_all_locked()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


__all__ = ["FleetClient"]
