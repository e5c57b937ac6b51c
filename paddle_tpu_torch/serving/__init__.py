"""Serving (counterpart of paddle_tpu/serving/): the InferenceEngine. The
RPC ModelServer, DynamicBatcher and InferClient are not ported yet."""

from .engine import InferenceEngine, parse_buckets

__all__ = ["InferenceEngine", "parse_buckets"]
