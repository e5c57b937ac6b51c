"""The port's PagedKVCache: the counterparts of the reference's allocator,
copy-on-write and reorder tests (tests/test_generation_serving.py:67-135)
and its prefix-cache accounting tests (tests/test_prefix_cache.py:58-233),
on arenas on the CPU. The block accounting is host-side and the same in
both packages; where a reference test writes the arena with ``.at[].set``,
these write the torch tensor in place, as the phase ops do."""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import PagedKVCache as JaxCache
from paddle_tpu_torch.serving import CacheExhausted, PagedKVCache


def _cache(*args, **kw):
    return PagedKVCache(*args, device="cpu", **kw)


def _write(c, slots, rows):
    flat = c.k[0].view(-1, *c.k[0].shape[2:])
    flat[torch.from_numpy(np.asarray(slots, np.int64))] = \
        torch.from_numpy(rows)


def test_arena_lives_on_the_requested_device_and_defaults_to_the_card():
    c = _cache(2, 2, 4, num_blocks=4, block_size=4)
    assert all(a.device.type == "cpu" and a.shape == (4, 4, 2, 4)
               and a.dtype == torch.float32 for a in c.k + c.v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            PagedKVCache(1, 1, 4, num_blocks=4, block_size=4)


def test_exhaustion_typed_and_admission_is_atomic():
    c = _cache(1, 1, 4, num_blocks=4, block_size=4)
    c.admit("a", 8)
    c.admit("b", 8)
    with pytest.raises(CacheExhausted):
        c.admit("c", 4)
    assert c.stats()["sequences"] == 2
    assert np.array_equal(c.append_slots("a", 8), np.arange(8))
    with pytest.raises(CacheExhausted):
        c.append_slots("a", 1)
    c.release("a")
    c.admit("c", 8)
    assert c.stats()["exhausted_rejects"] == 2


def test_recycle_then_realloc_reuses_freed_blocks():
    c = _cache(1, 1, 4, num_blocks=8, block_size=4)
    c.admit("a", 8)
    used = {int(s) // 4 for s in c.append_slots("a", 8)}
    assert c.stats()["blocks_in_use"] == 2
    c.release("a")
    assert c.stats()["blocks_in_use"] == 0
    c.admit("b", 8)
    assert {int(s) // 4 for s in c.append_slots("b", 8)} == {0, 1} == used


def test_cow_fork_leaves_parent_blocks_bitwise_intact():
    c = _cache(1, 2, 4, num_blocks=8, block_size=4)
    c.admit("p", 8, cow_headroom=1)
    slots = c.append_slots("p", 6)
    rows = np.random.RandomState(0).normal(0, 1, (6, 2, 4)) \
        .astype(np.float32)
    _write(c, slots, rows)
    before = c.k[0].clone()
    c.admit("q", 8, cow_headroom=1)
    c.fork("p", "q")
    assert c.context_len("q") == 6
    q_slot = c.append_slots("q", 1)[0]
    assert q_slot // 4 not in {0, 1}
    assert c.cow_copies == 1
    _write(c, [q_slot], np.full((1, 2, 4), 9, np.float32))
    after = c.k[0]
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[1], after[1])
    np.testing.assert_array_equal(
        after.reshape(-1, 2, 4)[(q_slot // 4) * 4 + 1].numpy(), rows[5])


def test_reorder_is_atomic_for_permutations():
    c = _cache(1, 1, 2, num_blocks=8, block_size=2)
    for s in ("a", "b"):
        c.admit(s, 4, cow_headroom=1)
    c.append_slots("a", 3)
    c.append_slots("b", 1)
    ta, tb = c.block_table("a", 4).copy(), c.block_table("b", 4).copy()
    c.reorder({"a": "b", "b": "a"})
    assert np.array_equal(c.block_table("a", 4), tb)
    assert np.array_equal(c.block_table("b", 4), ta)
    assert c.context_len("a") == 1 and c.context_len("b") == 3
    c.release("a")
    c.release("b")
    assert c.stats()["blocks_in_use"] == 0


def _drive(cache, script):
    """Run one host-side accounting script on a cache; returns what it
    observed (slots, tables, stats) for comparison across packages."""
    seen = []
    for op, *args in script:
        if op == "admit":
            try:
                seen.append(("admit", cache.admit(*args)))
            except Exception as e:
                seen.append(("admit", type(e).__name__))
        elif op == "slots":
            seen.append(("slots", cache.append_slots(*args).tolist()))
        elif op == "attach":
            seen.append(("attach", cache.attach_prefix(*args)))
        elif op == "register":
            seen.append(("register", cache.register_prefix(*args)))
        elif op == "fork":
            cache.fork(*args)
        elif op == "release":
            cache.release(*args)
        seen.append(("table", {s: list(t) for s, t in
                               sorted(cache._tables.items())}))
    st = cache.stats()
    keys = ("blocks_in_use", "blocks_free", "blocks_promised", "sequences",
            "cow_copies", "exhausted_rejects", "blocks_cached",
            "blocks_evictable", "prefix_hits", "prefix_misses",
            "prefix_evictions")
    seen.append(("stats", {k: st[k] for k in keys}))
    return seen


P10 = list(range(10))
SCRIPTS = {
    "cow_beam": [("admit", "p", 9, 1), ("slots", "p", 6),
                 ("admit", "q", 9, 1), ("fork", "p", "q"), ("slots", "q", 3),
                 ("slots", "p", 1), ("release", "p"), ("slots", "q", 1),
                 ("release", "q")],
    "prefix_reuse": [("admit", "a", 12), ("attach", "a", P10),
                     ("slots", "a", 10), ("register", "a", P10),
                     ("release", "a"), ("admit", "b", 12),
                     ("attach", "b", P10), ("slots", "b", 2),
                     ("admit", "c", 12), ("attach", "c", [9] * 10),
                     ("release", "b"), ("release", "c")],
    "pressure": [("admit", "L", 8), ("slots", "L", 8), ("admit", "p", 8),
                 ("slots", "p", 5), ("register", "p", [7] * 5),
                 ("release", "p"), ("admit", "n", 8), ("slots", "n", 8),
                 ("admit", "x", 4)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_accounting_matches_reference_cache(name):
    """The same admit/attach/append/fork/release script on both packages'
    caches: the same slots, block tables and counters at every step."""
    kw = dict(num_blocks=4 if name == "pressure" else 16, block_size=4,
              prefix_cache_blocks=4)
    got = _drive(_cache(1, 1, 4, **kw), SCRIPTS[name])
    want = _drive(JaxCache(1, 1, 4, **kw), SCRIPTS[name])
    assert got == want


def test_attach_register_hit_miss_accounting():
    c = _cache(1, 1, 4, num_blocks=16, block_size=4, prefix_cache_blocks=8)
    c.admit("a", 12)
    assert c.attach_prefix("a", P10) == 0
    c.append_slots("a", 10)
    assert c.register_prefix("a", P10) == 2
    a_blocks = list(c._tables["a"][:2])
    c.release("a")
    st = c.stats()
    assert st["blocks_cached"] == 2 and st["blocks_evictable"] == 2
    assert st["blocks_in_use"] == 2
    c.admit("b", 12)
    assert c.attach_prefix("b", P10) == 8
    assert c._tables["b"][:2] == a_blocks
    assert c.context_len("b") == 8
    assert c.prefix_hits == 2
    c.admit("d", 12)
    assert c.attach_prefix("d", [9] * 10) == 0
    assert c.prefix_misses >= 2
    c.admit("e", 8)
    assert c.attach_prefix("e", P10[:4]) == 0


@pytest.mark.parametrize("probe,want", [(1, 4), (3, 4), (2, 0)])
def test_lru_eviction_order_and_budget(probe, want):
    """Budget 2, prefixes 1 and 2 cached, 1 touched, 3 cached: prefix 2
    (the least recently used) was evicted; 1 and 3 still attach."""
    c = _cache(1, 1, 4, num_blocks=16, block_size=4, prefix_cache_blocks=2)
    prompts = {n: [n] * 5 for n in (1, 2, 3)}

    def prime(n):
        c.admit(n, 8)
        cached = c.attach_prefix(n, prompts[n])
        c.append_slots(n, 5 - cached)
        c.register_prefix(n, prompts[n])
        c.release(n)

    prime(1)
    prime(2)
    assert c.stats()["blocks_evictable"] == 2
    c.admit("t", 8)
    assert c.attach_prefix("t", prompts[1]) == 4
    c.append_slots("t", 1)
    c.release("t")
    prime(3)
    assert c.prefix_evictions == 1
    c.admit("probe", 8)
    assert c.attach_prefix("probe", prompts[probe]) == want


def test_chain_eviction_trims_the_tail_not_the_head():
    c = _cache(1, 1, 4, num_blocks=8, block_size=4, prefix_cache_blocks=2)
    prompt = list(range(13))
    c.admit("a", 16)
    c.append_slots("a", 13)
    assert c.register_prefix("a", prompt) == 3
    c.release("a")
    assert c.prefix_evictions == 1
    c.admit("b", 16)
    assert c.attach_prefix("b", prompt) == 8


def test_eviction_under_admission_pressure_never_evicts_live_blocks():
    c = _cache(1, 1, 4, num_blocks=4, block_size=4, prefix_cache_blocks=4)
    c.admit("L", 8)
    slots = c.append_slots("L", 8)
    _write(c, slots, np.arange(32, dtype=np.float32).reshape(8, 1, 4))
    live_blocks = set(c._tables["L"])
    before = c.k[0].clone()
    c.admit("p", 8)
    c.append_slots("p", 5)
    c.register_prefix("p", [7] * 5)
    cached_block = c._tables["p"][0]
    c.release("p")
    assert c.stats()["blocks_evictable"] == 1
    c.admit("n", 8)
    got = {int(s) // 4 for s in c.append_slots("n", 8)}
    assert got.isdisjoint(live_blocks)
    assert cached_block in got
    assert c.prefix_evictions == 1
    for b in live_blocks:
        assert torch.equal(c.k[0][b], before[b])
    with pytest.raises(CacheExhausted):
        c.admit("x", 4)


def test_cow_fork_leaves_cached_prefix_blocks_bitwise_intact():
    c = _cache(1, 2, 4, num_blocks=16, block_size=4, prefix_cache_blocks=8)
    prompt = list(range(6))
    c.admit("p", 8, cow_headroom=1)
    slots = c.append_slots("p", 6)
    _write(c, slots, np.random.RandomState(0).normal(0, 1, (6, 2, 4))
           .astype(np.float32))
    c.register_prefix("p", prompt)
    cached_block = c._tables["p"][0]
    before = c.k[0].clone()
    c.admit("q", 12, cow_headroom=1)
    assert c.attach_prefix("q", prompt) == 4
    c.append_slots("q", 3)
    assert c._tables["q"][0] == cached_block
    assert torch.equal(c.k[0][cached_block], before[cached_block])
    c.admit("r", 12, cow_headroom=1)
    c.fork("q", "r")
    r_slot = c.append_slots("r", 1)[0]
    assert r_slot // 4 != cached_block
    _write(c, [r_slot], np.full((1, 2, 4), 9.0, np.float32))
    assert torch.equal(c.k[0][cached_block], before[cached_block])
    for s in ("p", "q", "r"):
        c.release(s)
    c.admit("z", 8)
    assert c.attach_prefix("z", prompt) == 4


def test_budget_zero_is_the_pre_cache_behavior():
    c = _cache(1, 1, 4, num_blocks=8, block_size=4, prefix_cache_blocks=0)
    c.admit("a", 12)
    assert c.attach_prefix("a", P10) == 0
    c.append_slots("a", 10)
    assert c.register_prefix("a", P10) == 0
    c.release("a")
    st = c.stats()
    assert st["blocks_in_use"] == 0 and st["blocks_cached"] == 0
