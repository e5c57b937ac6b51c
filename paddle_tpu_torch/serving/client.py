"""InferClient: the typed client of a :class:`~.server.ModelServer`
(counterpart of paddle_tpu/serving/client.py, ported whole).

A thin stub over ``rpc.RpcClient``: feeds travel on the framed zero-copy
codec as numpy arrays, and connection-level failures (the server
restarting, a dropped connection) reconnect and resend under a
``RetryPolicy`` — safe because ``infer`` is stateless and idempotent.
Remote failures arrive as :class:`rpc.RemoteError` with the remote
exception's type name as a structured ``code``, and two codes re-raise
typed on every method (:func:`raise_typed`):

* :class:`~.batcher.ServerOverloaded` — the server's bounded queue
  rejected the request; back off (never retried automatically);
* :class:`~.batcher.QuotaExceeded` — the tenant's token bucket is empty.

The codes are the type names, so a client of either package re-raises its
own type against a server of either package.
"""

from __future__ import annotations

from ..distributed.rpc import (RemoteError, RetryPolicy, RpcClient,
                               WIRE_FRAMED)
from .batcher import QuotaExceeded, ServerOverloaded

# structured wire code -> client-side exception type: the ONE table the
# typed re-raise reads, so a new typed serving condition is one row here
# (server side just raises the type; RpcServer ships type(e).__name__ as
# the code) instead of another hardwired special case
WIRE_CODE_EXCEPTIONS = {
    "ServerOverloaded": ServerOverloaded,
    "QuotaExceeded": QuotaExceeded,
}


def raise_typed(e):
    """Re-raise a :class:`RemoteError` as its typed client-side form when
    its structured code names one (:data:`WIRE_CODE_EXCEPTIONS`) — the
    ONE place the wire-code -> client-type mapping lives (InferClient and
    GenClient both route every remote failure through it)."""
    cls = WIRE_CODE_EXCEPTIONS.get(e.code)
    if cls is not None:
        raise cls(e.remote_message) from None
    raise e


class InferClient:
    """``InferClient(address)`` retries connection failures by default
    (``retry=None`` disables; pass a ``RetryPolicy`` to tune)."""

    def __init__(self, address, timeout=None, retry=True, wire=WIRE_FRAMED):
        if retry is True:
            retry = RetryPolicy()
        self._rpc = RpcClient(address, timeout=timeout, retry=retry or None,
                              wire=wire)

    def _call(self, method, **kwargs):
        """One RPC with the structured-code overload mapping applied
        uniformly (infer, health and stats alike — a drained-but-loaded
        server may reject any of them under backpressure)."""
        try:
            return self._rpc.call(method, **kwargs)
        except RemoteError as e:
            raise_typed(e)

    def infer(self, feed, model=None, tenant=None):
        """One request; returns the fetch arrays for these rows. Raises
        :class:`ServerOverloaded` when the server rejected under
        backpressure and :class:`QuotaExceeded` when ``tenant`` is over
        its quota. ``model`` routes to a named hosted model on a
        multi-model server; both default to None and are then OMITTED
        from the wire call, keeping the single-model request shape
        bitwise what it always was."""
        kwargs = {"feed": feed}
        if model is not None:
            kwargs["model"] = model
        if tenant is not None:
            kwargs["tenant"] = tenant
        return self._call("infer", **kwargs)

    def health(self):
        return self._call("health")

    def stats(self):
        return self._call("stats")

    def wire_stats(self):
        return self._rpc.wire_stats.snapshot()

    def close(self):
        self._rpc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


__all__ = ["InferClient"]
