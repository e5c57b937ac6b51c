"""Global flags registry (counterpart of paddle_tpu/core/flags.py), holding
only the flags the ported paths read: ``kernel_tier``,
``serving_batch_buckets`` and the generation-serving flags (reference
:216-330, without the KV spill tier's ``serving_kv_spill_dir`` and
``serving_kv_spill_bytes``)."""

from __future__ import annotations

_FLAGS: dict[str, dict] = {}


def DEFINE_flag(name, default, help_str=""):
    if name not in _FLAGS:
        _FLAGS[name] = {"value": default, "default": default,
                        "help": help_str, "type": type(default)}
    return _FLAGS[name]["value"]


def get_flag(name):
    return _FLAGS[name]["value"]


def set_flags(flags: dict):
    """fluid.set_flags({'kernel_tier': 'torch'}) — unknown flags raise."""
    for name, value in flags.items():
        if name not in _FLAGS:
            raise KeyError(f"unknown flag {name!r}; known: {sorted(_FLAGS)}")
        _FLAGS[name]["value"] = _FLAGS[name]["type"](value)


DEFINE_flag("kernel_tier", "auto",
            "which lowering the hot-op dispatch sites use: 'auto' (the "
            "hand-written kernel for CUDA tensors, the plain PyTorch op "
            "chain for CPU tensors), 'cuda' (the kernel route for every "
            "supported shape; on CPU tensors the kernel wrapper runs its "
            "plain twin), or 'torch' (the plain PyTorch op chain "
            "everywhere). A shape outside a kernel's supported() set routes "
            "to the plain op chain and bumps ops.cuda.fallback_counts()")

DEFINE_flag("serving_batch_buckets", "1,2,4,8,16,32",
            "comma-separated batch buckets the serving InferenceEngine pads "
            "incoming batches up to; batches beyond the largest bucket are "
            "chunked through it (serving/engine.py)")

DEFINE_flag("serving_queue_capacity", 256,
            "bound on requests waiting in a serving queue (the generation "
            "ContinuousBatcher's). When full, new requests are rejected fast "
            "with a typed ServerOverloaded the client can back off on")

DEFINE_flag("serving_kv_block_size", 16,
            "tokens per KV-cache block in the generation-serving paged arena "
            "(serving/generate/kvcache.py): each sequence's context occupies "
            "ceil(len/block_size) blocks addressed through its block table. "
            "One block is also the copy-on-write unit for beam forks")

DEFINE_flag("serving_kv_num_blocks", 256,
            "blocks in the pre-allocated per-layer KV arena ([num_blocks, "
            "block_size, heads, head_dim] per layer, K and V). When a "
            "request's worst case cannot be promised from the free blocks, "
            "admission rejects typed with CacheExhausted and the scheduler "
            "keeps it queued")

DEFINE_flag("serving_prefix_cache_blocks", 0,
            "budget of refcount-0 KV blocks the paged arena retains as a "
            "shared-prefix cache instead of recycling eagerly: full prompt "
            "blocks are content-hash-chained at prefill, and a new request "
            "whose prompt starts with a cached chain attaches to those "
            "blocks and prefills only its uncached tail. Evicted least "
            "recently used past the budget or under admission pressure; 0 "
            "disables retention")

DEFINE_flag("serving_prefill_chunk", 0,
            "when > 0, a prompt's uncached prefill runs in chunks of at most "
            "this many tokens, one chunk per decode step boundary, so a long "
            "cold prompt admits without stalling in-flight decode streams. "
            "0 keeps single-dispatch prefill")

DEFINE_flag("serving_max_seqs", 8,
            "decode slots in the generation engine's one fixed-shape "
            "[max_seqs, 1] decode dispatch: the bound on concurrent "
            "in-flight sequences")
