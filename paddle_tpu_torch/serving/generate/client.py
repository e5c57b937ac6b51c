"""GenClient: the streaming twin of InferClient (counterpart of
paddle_tpu/serving/generate/client.py, ported whole).

``generate()`` is a generator over the server's multi-frame streaming
response: each frame carries the tokens the continuous batcher produced
for this request since the last frame, so the caller sees tokens as they
decode. Remote failures keep the typed contract:
:class:`~..batcher.ServerOverloaded` when the generation wait queue
rejected the request, else :class:`~...distributed.rpc.RemoteError`,
raised mid-stream at the frame where the server failed.

Connection failures are not retried: a stream is stateful, so the caller
owns whole-stream retries. One client carries one stream at a time; use
one GenClient per concurrent stream. Abandoning the iterator cancels the
request server-side, and the scheduler frees its slot and blocks.
"""

from __future__ import annotations

from ...distributed.rpc import RemoteError, RpcClient, WIRE_FRAMED
from ..client import raise_typed


class GenClient:
    def __init__(self, address, timeout=None, wire=WIRE_FRAMED):
        self._rpc = RpcClient(address, timeout=timeout, retry=None,
                              wire=wire)

    def generate(self, prompt, max_new_tokens, sampling=None, model=None,
                 tenant=None):
        """Yield generated token ids for ``prompt`` as the server decodes
        them. ``sampling`` is the ``normalize_sampling`` dict form
        ({"mode": "greedy"|"topk"|"beam", ...}); beam streams emit the
        winning hypothesis once, at completion. ``model=`` targets a
        named hosted model on a multi-model server; ``tenant=`` tags the
        request for quota accounting (:class:`~..batcher.QuotaExceeded`
        re-raises typed). Both are omitted from the wire frame when None,
        so single-model call shapes are unchanged."""
        kwargs = {"prompt": [int(t) for t in prompt],
                  "max_new_tokens": int(max_new_tokens),
                  "sampling": sampling}
        if model is not None:
            kwargs["model"] = str(model)
        if tenant is not None:
            kwargs["tenant"] = str(tenant)
        try:
            for frame in self._rpc.stream("generate", **kwargs):
                for t in frame["tokens"]:
                    yield int(t)
        except RemoteError as e:
            raise_typed(e)

    def _call(self, method, **kwargs):
        try:
            return self._rpc.call(method, **kwargs)
        except RemoteError as e:
            raise_typed(e)

    def health(self):
        return self._call("health")

    def stats(self):
        return self._call("stats")

    def close(self):
        self._rpc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


__all__ = ["GenClient"]
