"""Serving backpressure (counterpart of paddle_tpu/serving/batcher.py):
only :class:`ServerOverloaded` (reference :64), which the generation
scheduler raises from where the reference defines it. The
``DynamicBatcher`` and tenant quotas are not ported yet."""

from __future__ import annotations


class ServerOverloaded(RuntimeError):
    """The serving queue is full: reject-fast backpressure. Clients should
    back off and retry or shed the request."""


__all__ = ["ServerOverloaded"]
