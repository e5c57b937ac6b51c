"""Paged KV-cache arena: fixed-size blocks, per-sequence block tables
(counterpart of paddle_tpu/serving/generate/kvcache.py).

One pre-allocated ``[num_blocks, block_size, heads, head_dim]`` K and V
tensor per layer on the engine's device, carved into blocks that a
sequence's context occupies non-contiguously. A sequence owns a BLOCK
TABLE (ordered block ids); position ``p`` of its context lives at flat
arena slot ``table[p // block_size] * block_size + p % block_size``.
Ragged in-flight sequences share one fixed-shape decode dispatch: the
block table, not the tensor shape, carries each sequence's length.

Admission control is typed: a sequence is admitted only when enough free
blocks exist for its worst-case length (prompt + max new tokens), so
decode never fails for want of a block mid-flight; otherwise
:class:`CacheExhausted` rejects at once and the scheduler keeps the
request queued. Blocks recycle the moment a sequence finishes.

Beam search forks hypotheses copy-on-write: a fork shares the parent's
blocks (refcounted); a hypothesis that writes into a shared tail block
first draws a fresh block and copies that one block on the device, so the
parent's blocks are never touched. Beam slots are admitted with one block
of COW headroom on top of the worst case.

Shared-prefix caching: every full prompt block is content-hash-chained at
prefill, ``h_i = sha1(h_{i-1} || tokens of block i)``, so one hash names a
whole prefix. A new request whose prompt starts with a cached chain
attaches to those blocks (a refcount bump under the COW protection) and
prefills only its uncached tail; at least the last prompt token always
re-prefills so the first sample has logits. Released registered blocks
park in an LRU pool (budget ``serving_prefix_cache_blocks``; 0 disables
retention) and are evicted oldest first, their hash unregistered, when
the pool overflows or an admission needs the block. Blocks a live
sequence holds are never candidates.

Not ported: the reference's persistent spill tier (``attach_spill``,
``_block_kv``, ``_try_restore``, ``spill_registered`` over
``serving/generate/kvstore.py``) — eviction here discards.

The arena tensors (``self.k[l]`` / ``self.v[l]``) are written in place by
the phase ops (ops/attention_ops.py) the engine dispatches; this class
owns the host-side accounting (free list, refcounts, tables,
reservations, the prefix-hash index) and the device block copies COW
needs. Its counters and gauges are the reference's obs.metrics families
(``paddle_tpu_kvcache_*``, per cache instance); the attributes and
``stats()`` read them.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from ...core.executor import resolve_device
from ...core.flags import get_flag
from ...obs.metrics import REGISTRY as _METRICS, next_instance

_M_BLOCKS_IN_USE = _METRICS.gauge(
    "paddle_tpu_kvcache_blocks_in_use",
    "KV arena blocks currently allocated, per cache instance",
    labels=("instance",))
_M_REJECTS = _METRICS.counter(
    "paddle_tpu_kvcache_rejects",
    "CacheExhausted rejections (admission, budget, COW overdraw), "
    "per cache instance", labels=("instance",))
_M_COW = _METRICS.counter(
    "paddle_tpu_kvcache_cow_copies",
    "copy-on-write block copies taken by beam forks, per cache instance",
    labels=("instance",))
_M_PREFIX_HITS = _METRICS.counter(
    "paddle_tpu_kvcache_prefix_hits",
    "prompt blocks attached from the shared-prefix cache instead of "
    "being re-prefilled, per cache instance", labels=("instance",))
_M_PREFIX_MISSES = _METRICS.counter(
    "paddle_tpu_kvcache_prefix_misses",
    "admissions whose prompt had cacheable full blocks beyond the "
    "matched chain (the walk stopped on an unregistered hash), per "
    "cache instance", labels=("instance",))
_M_PREFIX_EVICTIONS = _METRICS.counter(
    "paddle_tpu_kvcache_prefix_evictions",
    "cached prefix blocks evicted (LRU: pool over budget or admission "
    "pressure), per cache instance", labels=("instance",))
_M_BLOCKS_CACHED = _METRICS.gauge(
    "paddle_tpu_kvcache_blocks_cached",
    "blocks currently registered in the shared-prefix hash index "
    "(live-referenced + evictable), per cache instance",
    labels=("instance",))


class CacheExhausted(RuntimeError):
    """Not enough free KV blocks to admit (or COW-fork) a sequence: typed
    admission rejection — the scheduler keeps the request queued until
    blocks recycle."""


class PagedKVCache:
    """``PagedKVCache(num_layers, num_heads, head_dim)`` — block size and
    block count default from the ``serving_kv_block_size`` /
    ``serving_kv_num_blocks`` flags; the arenas live on ``device``, the
    card by default."""

    def __init__(self, num_layers, num_heads, head_dim, num_blocks=None,
                 block_size=None, dtype=torch.float32,
                 prefix_cache_blocks=None, device=None):
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size if block_size is not None
                              else get_flag("serving_kv_block_size"))
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else get_flag("serving_kv_num_blocks"))
        if self.block_size <= 0 or self.num_blocks <= 0:
            raise ValueError(
                f"KV arena needs positive block_size/num_blocks, got "
                f"{self.block_size}/{self.num_blocks}")
        self.device = resolve_device() if device is None \
            else torch.device(device)
        shape = (self.num_blocks, self.block_size, self.num_heads,
                 self.head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=self.device)
                  for _ in range(self.num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=self.device)
                  for _ in range(self.num_layers)]
        # free list popped from the END: initialized descending so blocks
        # allocate 0, 1, 2, ... (deterministic tests, dense arena use)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref = [0] * self.num_blocks
        self._tables = {}        # seq_id -> [block ids]
        self._lens = {}          # seq_id -> tokens written
        self._promised = {}      # seq_id -> admission-time block budget
        self._promised_total = 0
        self.prefix_cache_blocks = int(
            prefix_cache_blocks if prefix_cache_blocks is not None
            else get_flag("serving_prefix_cache_blocks"))
        self._hash_to_block = {}   # chain hash -> registered block id
        self._block_hash = {}      # registered block id -> chain hash
        # refcount-0 registered blocks, insertion order = LRU (oldest
        # first)
        self._evictable = OrderedDict()
        self.obs_instance = next_instance("kvcache")
        labels = dict(instance=self.obs_instance)
        self._m_in_use = _M_BLOCKS_IN_USE.labels(**labels)
        self._m_rejects = _M_REJECTS.labels(**labels)
        self._m_cow = _M_COW.labels(**labels)
        self._m_prefix_hits = _M_PREFIX_HITS.labels(**labels)
        self._m_prefix_misses = _M_PREFIX_MISSES.labels(**labels)
        self._m_prefix_evictions = _M_PREFIX_EVICTIONS.labels(**labels)
        self._m_blocks_cached = _M_BLOCKS_CACHED.labels(**labels)
        self._m_in_use.set(0)
        self._m_blocks_cached.set(0)

    # ------------------------------------------------------------------
    @property
    def sentinel_slot(self):
        """One-past-the-end flat slot: scatters to it are dropped by the
        phase ops — the write-nothing encoding for padding positions and
        inactive decode rows."""
        return self.num_blocks * self.block_size

    def blocks_for(self, n_tokens):
        return -(-int(n_tokens) // self.block_size)

    def available_blocks(self):
        """Free blocks not yet committed to an admitted sequence's worst
        case. Cached refcount-0 blocks count: they evict on demand."""
        return (len(self._free) + len(self._evictable)
                - self._promised_unspent())

    # ------------------------------------------------------------------
    def admit(self, seq_id, max_total_len, cow_headroom=0):
        """Reserve worst-case capacity for a new sequence; raises
        :class:`CacheExhausted` (and changes nothing) when the arena
        cannot promise it. ``cow_headroom`` adds blocks for beam slots."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already admitted")
        need = self.blocks_for(max_total_len) + int(cow_headroom)
        free_uncommitted = self.available_blocks()
        if need > free_uncommitted:
            self._m_rejects.inc()
            raise CacheExhausted(
                f"KV arena exhausted: sequence needs {need} blocks "
                f"(max_total_len={max_total_len}, block_size="
                f"{self.block_size}) but only {max(0, free_uncommitted)} "
                f"of {self.num_blocks} are uncommitted")
        self._tables[seq_id] = []
        self._lens[seq_id] = 0
        self._promised[seq_id] = need
        self._promised_total += need
        return need

    def _promised_unspent(self):
        # what admitted sequences may still draw: promise minus the blocks
        # their tables hold
        return sum(max(0, self._promised[s] - len(self._tables[s]))
                   for s in self._tables)

    def _draw(self):
        if not self._free and self._evictable:
            # admission pressure: evict the least recently used cached
            # block (refcount 0: live blocks are never in the pool)
            self._evict_lru()
        if not self._free:
            self._m_rejects.inc()
            raise CacheExhausted(
                "KV arena free list empty (copy-on-write overdraw?); "
                "admit beam sequences with cow_headroom >= 1")
        b = self._free.pop()
        self._ref[b] = 1
        self._m_in_use.set(self.num_blocks - len(self._free))
        return b

    # ------------------------------------------------------------------
    # shared-prefix cache
    # ------------------------------------------------------------------
    def _chain_hashes(self, tokens, n_blocks):
        """Content-hash chain over the first ``n_blocks`` full blocks of
        ``tokens``: hash i commits to every token of blocks 0..i."""
        hashes, h = [], b""
        for i in range(n_blocks):
            blk = tokens[i * self.block_size:(i + 1) * self.block_size]
            h = hashlib.sha1(
                h + np.asarray(blk, np.int64).tobytes()).digest()
            hashes.append(h)
        return hashes

    def _cacheable_blocks(self, tokens):
        # full prompt blocks, capped so the LAST prompt token always
        # re-prefills (the first sample needs its logits)
        return max(0, (len(tokens) - 1) // self.block_size)

    def attach_prefix(self, seq_id, tokens):
        """Attach the longest cached chain matching ``tokens``'s full
        prompt blocks to freshly admitted ``seq_id``. Returns the attached
        length in tokens (0 when the cache is disabled or nothing
        matches)."""
        if self._tables[seq_id] or self._lens[seq_id]:
            raise ValueError(
                f"attach_prefix on {seq_id!r} after writes (len="
                f"{self._lens[seq_id]})")
        n = self._cacheable_blocks(tokens)
        if self.prefix_cache_blocks <= 0 or n <= 0:
            return 0
        table = self._tables[seq_id]
        matched = 0
        for h in self._chain_hashes(tokens, n):
            b = self._hash_to_block.get(h)
            if b is None:
                self._m_prefix_misses.inc()
                break
            if self._ref[b] == 0:
                self._evictable.pop(b)
            self._ref[b] += 1
            table.append(b)
            matched += 1
            self._m_prefix_hits.inc()
        self._lens[seq_id] = matched * self.block_size
        return matched * self.block_size

    def register_prefix(self, seq_id, tokens):
        """Register ``seq_id``'s full prompt blocks in the hash index once
        the whole prompt is written (already registered hashes keep their
        block). Returns the number of newly registered blocks."""
        if self.prefix_cache_blocks <= 0:
            return 0
        n = min(self._cacheable_blocks(tokens),
                self._lens[seq_id] // self.block_size)
        table = self._tables[seq_id]
        new = 0
        for i, h in enumerate(self._chain_hashes(tokens, n)):
            if h in self._hash_to_block:
                continue
            b = table[i]
            if b in self._block_hash:
                # a COW copy of a block registered under an earlier chain:
                # never alias one block to two hashes
                continue
            self._hash_to_block[h] = b
            self._block_hash[b] = h
            new += 1
        if new:
            self._m_blocks_cached.set(len(self._block_hash))
        return new

    def _evict_lru(self):
        b, _ = self._evictable.popitem(last=False)
        h = self._block_hash.pop(b)
        del self._hash_to_block[h]
        self._free.append(b)
        self._m_prefix_evictions.inc()
        self._m_blocks_cached.set(len(self._block_hash))

    # ------------------------------------------------------------------
    def append_slots(self, seq_id, n=1):
        """Flat arena slots for this sequence's next ``n`` positions (int32
        [n]), growing the block table as needed and copy-on-writing a
        shared tail block first. Call BEFORE the dispatch that writes
        them."""
        table = self._tables[seq_id]
        pos = self._lens[seq_id]
        if pos + n > self._promised[seq_id] * self.block_size:
            self._m_rejects.inc()
            raise CacheExhausted(
                f"sequence {seq_id!r} exceeds its admitted budget "
                f"({self._promised[seq_id]} blocks) at position {pos + n}")
        slots = np.empty(n, np.int32)
        for i in range(n):
            p = pos + i
            bi = p // self.block_size
            if bi == len(table):
                table.append(self._draw())
            elif self._ref[table[bi]] > 1:
                table[bi] = self._cow(table[bi])
            slots[i] = table[bi] * self.block_size + p % self.block_size
        self._lens[seq_id] = pos + n
        return slots

    def _cow(self, block):
        """Copy-on-write: draw a fresh block, copy the shared block into it
        in every layer's K and V arena on the device, and drop one
        reference to the shared block, whose bytes are never modified."""
        nb = self._draw()
        for arena in (self.k, self.v):
            for a in arena:
                a[nb].copy_(a[block])
        self._ref[block] -= 1
        self._m_cow.inc()
        return nb

    # ------------------------------------------------------------------
    def context_len(self, seq_id):
        return self._lens[seq_id]

    def block_table(self, seq_id, pad_to):
        """The sequence's block table padded with 0 to ``pad_to`` entries
        (padded entries are masked out by ContextLens in the op)."""
        t = self._tables[seq_id]
        if len(t) > pad_to:
            raise ValueError(
                f"sequence {seq_id!r} spans {len(t)} blocks > table "
                f"width {pad_to}")
        out = np.zeros(pad_to, np.int32)
        out[:len(t)] = t
        return out

    # ------------------------------------------------------------------
    def reorder(self, mapping):
        """Atomically rebind destination sequences to copies of source
        sequences' block tables (``{dst_seq: src_seq}``) — the beam-step
        fork. All sources are read (and their blocks ref-bumped) before
        any destination's old table is released, so a permutation never
        frees a block another binding still needs."""
        new = {d: (list(self._tables[s]), self._lens[s])
               for d, s in mapping.items()}
        for table, _ in new.values():
            for b in table:
                self._ref[b] += 1
        for d in mapping:
            self._release_blocks(self._tables[d])
        for d, (table, length) in new.items():
            self._tables[d] = table
            self._lens[d] = length

    def fork(self, src_seq, dst_seq):
        """Share ``src``'s context into (already admitted) ``dst``."""
        self.reorder({dst_seq: src_seq})

    # ------------------------------------------------------------------
    def _release_blocks(self, blocks):
        parked = []
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if b in self._block_hash:
                    parked.append(b)
                else:
                    self._free.append(b)
        # registered blocks park in REVERSE table order, so a chain's
        # deepest block is the eviction-oldest: a chain is only ever
        # trimmed from its tail
        for b in reversed(parked):
            self._evictable[b] = None
            self._evictable.move_to_end(b)
        while len(self._evictable) > self.prefix_cache_blocks:
            self._evict_lru()
        self._m_in_use.set(self.num_blocks - len(self._free))

    def release(self, seq_id):
        """Finish a sequence: recycle its blocks (refcounted) and return
        its reservation. Freed blocks go to the END of the free list, so
        the next draw reuses the most recently freed block; registered
        prefix blocks park in the LRU pool instead."""
        self._release_blocks(self._tables.pop(seq_id))
        del self._lens[seq_id]
        self._promised_total -= self._promised.pop(seq_id)

    # ------------------------------------------------------------------
    @property
    def cow_copies(self):
        return int(self._m_cow.value)

    @property
    def exhausted_rejects(self):
        """CacheExhausted rejections: admission, per-sequence budget and
        COW overdraw alike."""
        return int(self._m_rejects.value)

    @property
    def prefix_hits(self):
        return int(self._m_prefix_hits.value)

    @property
    def prefix_misses(self):
        return int(self._m_prefix_misses.value)

    @property
    def prefix_evictions(self):
        return int(self._m_prefix_evictions.value)

    def stats(self):
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_in_use": self.num_blocks - len(self._free),
            "blocks_free": len(self._free),
            "blocks_promised": self._promised_total,
            "sequences": len(self._tables),
            "cow_copies": self.cow_copies,
            "exhausted_rejects": self.exhausted_rejects,
            "prefix_cache_blocks": self.prefix_cache_blocks,
            "blocks_cached": len(self._block_hash),
            "blocks_evictable": len(self._evictable),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_evictions": self.prefix_evictions,
        }


__all__ = ["PagedKVCache", "CacheExhausted"]
