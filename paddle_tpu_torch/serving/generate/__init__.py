"""Generation serving: continuous batching over a paged KV cache
(counterpart of paddle_tpu/serving/generate/).

A generative saved program (a decoder-only LM authored with
``fluid.layers.causal_self_attention`` sites, see
``testing/models.build_tiny_lm``) serves autoregressive token streams,
every in-flight sequence at its own length.

* :class:`PagedKVCache` (kvcache.py) — the paged KV arena on the card:
  fixed-size blocks, per-sequence block tables, typed
  :class:`CacheExhausted` admission control, block recycling,
  copy-on-write beam forks and the shared-prefix cache, with its
  persistent spill tier (kvstore.py, :class:`KVStore`).
* :class:`GenerationEngine` (decode_engine.py) — splits the saved program
  into a per-bucket prefill phase, a chunked-prefill phase (cached-prefix
  tails, bounded chunks interleaved with decode) and one fixed-shape
  ``[max_seqs, 1]`` decode phase over the arena, whose attention is the
  hand-written paged-attention CUDA kernel; greedy / top-k / beam sampling
  host-side per sequence.
* :class:`ContinuousBatcher` (scheduler.py) — sequences join the running
  batch at any step boundary and leave at EOS or max length; a bounded
  wait queue with the typed ``ServerOverloaded`` fast reject.
* :class:`GenClient` (client.py) — the streaming RPC client of a
  generative ``ModelServer``: tokens arrive frame by frame as they decode.
"""

from .kvcache import PagedKVCache, CacheExhausted
from .kvstore import KVStore
from .decode_engine import (GenerationEngine, NoFreeSlots,
                            normalize_sampling)
from .scheduler import ContinuousBatcher, TokenStream
from .client import GenClient

__all__ = ["PagedKVCache", "CacheExhausted", "KVStore", "GenerationEngine",
           "NoFreeSlots", "normalize_sampling", "ContinuousBatcher",
           "TokenStream", "GenClient"]
