"""Serving (counterpart of paddle_tpu/serving/): the feed-forward
InferenceEngine, and the generation subsystem (``serving/generate``:
GenerationEngine over a paged KV cache, ContinuousBatcher) with the
``ServerOverloaded`` backpressure error. The RPC ModelServer,
DynamicBatcher, InferClient and GenClient are not ported yet."""

from .batcher import ServerOverloaded
from .engine import InferenceEngine, parse_buckets
from .generate import (CacheExhausted, ContinuousBatcher, GenerationEngine,
                       NoFreeSlots, PagedKVCache, TokenStream,
                       normalize_sampling)

__all__ = ["InferenceEngine", "parse_buckets", "ServerOverloaded",
           "CacheExhausted", "ContinuousBatcher", "GenerationEngine",
           "NoFreeSlots", "PagedKVCache", "TokenStream",
           "normalize_sampling"]
