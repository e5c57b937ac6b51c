"""The port's KV-prefix spill tier (paddle_tpu_torch/serving/generate/
kvstore.py and the spill hooks of kvcache.py) on the CPU: the counterpart of
tests/test_kv_spill.py, on the bundle the reference exports (its tests'
tiny LM).

* eviction demotes a refcount-0 registered block to the store instead of
  discarding it, and the next attach restores it (zero full-window prefill
  dispatches for the restored prefix);
* a fresh engine attaches another engine's spilled chain: every sampling
  mode's token stream is bitwise the cold (hot-attach) stream, and the
  greedy stream equals the reference engine's on the same bundle;
* the byte budget evicts the oldest artifacts and refuses an oversize one;
* corrupt, foreign and manifest-unlisted artifacts reject typed and the
  engine prefills instead, with the same tokens;
* the fingerprint covers every identity axis; the store resolves a
  published ``kv/`` dir, then the flag, else nothing.
"""

import hashlib
import json
import os
import pickle

import numpy as np
import pytest
import torch

from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.testing.models import export_tiny_lm
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.flags import get_flag, set_flags
from paddle_tpu_torch.ops.cuda import build as kbuild
from paddle_tpu_torch.serving import GenerationEngine, ModelRegistry
from paddle_tpu_torch.serving.generate import kvstore
from paddle_tpu_torch.serving.generate.kvstore import (KVStore,
                                                       kv_fingerprint,
                                                       resolve_store)

VOCAB = 17
PROMPT = list(range(1, 11))                    # 2 cacheable blocks at bs=4
REQUESTS = [
    (PROMPT, 5, None),
    (PROMPT, 6, {"mode": "topk", "top_k": 4, "seed": 11}),
    (PROMPT, 4, {"mode": "beam", "beam_size": 2, "eos_id": 0}),
]
ENGINE = dict(max_seqs=4, block_size=4, num_blocks=64, max_len=32,
              prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def lm_bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spilllm") / "model")
    export_tiny_lm(d, vocab=VOCAB, emb=8, heads=2, n_layers=2, max_pos=64,
                   seed=3)
    return d


@pytest.fixture
def flags_guard():
    saved = {n: get_flag(n) for n in ("serving_kv_spill_dir",
                                      "serving_kv_spill_bytes",
                                      "kernel_tier")}
    yield
    set_flags(saved)


def _engine(d, **kw):
    return GenerationEngine(d, place=fluid.CPUPlace(), **{**ENGINE, **kw})


def _drain(eng, handle, first, finished):
    toks = list(first)
    while not finished:
        for h, ts, f in eng.step():
            if h is handle:
                toks += ts
                finished = f
    return toks


def _prefills(eng):
    return sum(s["dispatches"]
               for s in eng.stats()["phases"]["prefill"].values())


def _fill_spill(d, spill_dir):
    """Prefill PROMPT once and persist its chain; returns the artifact
    bytes by basename."""
    set_flags({"serving_kv_spill_dir": str(spill_dir)})
    w = _engine(d, prefix_cache_blocks=16)
    w.warmup()
    _drain(w, *w.start(PROMPT, 5))
    assert w.cache.spill_registered() == 2
    st = w.stats()["kv_store"]
    assert st["writes"] == 2 and not st["readonly"]
    arts = {}
    for n in sorted(os.listdir(spill_dir)):
        if n.endswith(kvstore.ARTIFACT_SUFFIX):
            with open(os.path.join(spill_dir, n), "rb") as f:
                arts[n] = f.read()
    assert len(arts) == 2
    return arts


def test_spill_hit_tokens_bitwise_hot_attach_and_reference(
        lm_bundle, tmp_path, flags_guard):
    hot = _engine(lm_bundle, prefix_cache_blocks=16, kv_store=False)
    hot.warmup()
    _drain(hot, *hot.start(PROMPT, 5))        # registers the chain in arena
    want = [_drain(hot, *hot.start(p, m, s)) for p, m, s in REQUESTS]
    assert hot.stats()["cache"]["prefix_hits"] >= 6

    _fill_spill(lm_bundle, tmp_path / "spill")
    reader = _engine(lm_bundle, prefix_cache_blocks=16)
    reader.warmup()
    before = _prefills(reader)
    got = [_drain(reader, *reader.start(p, m, s)) for p, m, s in REQUESTS]
    assert got == want
    st = reader.stats()
    assert st["kv_store"]["restores"] == 2
    assert sum(st["kv_store"]["rejects"].values()) == 0
    assert st["cache"]["spill"]["restores"] == 2
    # the restored prefix is attached, not prefilled: no full-window
    # prefill dispatch (the last prompt token goes through the chunk phase)
    assert _prefills(reader) == before
    assert st["hot_recompiles"] == 0

    jeng = JaxEngine(lm_bundle, **ENGINE)
    jeng.warmup()
    jtoks = _drain(jeng, *jeng.start(PROMPT, 5))
    assert got[0] == jtoks


def test_eviction_demotes_then_attach_restores(lm_bundle, tmp_path,
                                               flags_guard):
    set_flags({"serving_kv_spill_dir": str(tmp_path / "spill")})
    eng = _engine(lm_bundle, prefix_cache_blocks=1)
    eng.warmup()
    first = _drain(eng, *eng.start(PROMPT, 5))
    st = eng.stats()
    assert st["cache"]["prefix_evictions"] == 1
    assert st["kv_store"]["writes"] == 1        # demoted, not discarded
    again = _drain(eng, *eng.start(PROMPT, 5))
    assert again == first
    st = eng.stats()
    assert st["kv_store"]["restores"] == 1
    assert sum(st["kv_store"]["rejects"].values()) == 0


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "foreign",
                                    "geometry"])
def test_corrupt_artifacts_reject_typed_and_prefill(lm_bundle, tmp_path,
                                                   flags_guard, damage):
    spill = tmp_path / "spill"
    cold = _engine(lm_bundle, kv_store=False)
    cold.warmup()
    want = _drain(cold, *cold.start(PROMPT, 5))
    arts = _fill_spill(lm_bundle, spill)
    name = sorted(arts)[0]
    raw = arts[name]
    path = os.path.join(spill, name)
    if damage == "bitflip":
        bad = raw[:-5] + bytes([raw[-5] ^ 1]) + raw[-4:]
        reason = "format"
    elif damage == "truncate":
        bad = raw[:len(raw) // 2]
        reason = "format"
    else:
        blob = raw[raw.index(b"\n", len(kvstore._MAGIC)) + 1:]
        doc = pickle.loads(blob)
        if damage == "foreign":
            doc["fingerprint"] = dict(doc["fingerprint"], device="other")
            reason = "fingerprint"
        else:
            doc["k"] = doc["k"][:, :2]
            reason = "deserialize"
        blob = pickle.dumps(doc)
        bad = (kvstore._MAGIC + hashlib.sha256(blob).hexdigest().encode()
               + b"\n" + blob)
    with open(path, "wb") as f:
        f.write(bad)
    eng = _engine(lm_bundle, prefix_cache_blocks=16)
    eng.warmup()
    got = _drain(eng, *eng.start(PROMPT, 5))
    assert got == want                         # prefill fallback, bitwise
    rejects = eng.stats()["kv_store"]["rejects"]
    assert rejects[reason] >= 1, rejects


def test_budget_evicts_oldest_and_refuses_oversize(tmp_path):
    fp = kv_fingerprint("h", 2, 2, 4, 4, torch.float32,
                        torch.device("cpu"))
    k = torch.zeros((2, 4, 2, 4))
    probe = KVStore(str(tmp_path / "probe"), fp)
    size = os.path.getsize(probe.save(b"\x00" * 20, k, k))
    store = KVStore(str(tmp_path / "s"), fp, budget_bytes=2 * size + 10)
    p1 = store.save(b"\x01" * 20, k, k)
    os.utime(p1, (1, 1))                       # the oldest
    store.save(b"\x02" * 20, k, k)
    store.save(b"\x03" * 20, k, k)             # evicts the oldest first
    assert not os.path.exists(p1)
    assert len(store.artifacts()) == 2
    assert store.stats()["bytes"] <= store.budget_bytes
    tiny = KVStore(str(tmp_path / "tiny"), fp, budget_bytes=size - 1)
    assert tiny.save(b"\x04" * 20, k, k) is None
    assert tiny.artifacts() == []
    ro = KVStore(str(tmp_path / "s"), fp, readonly=True)
    assert ro.save(b"\x05" * 20, k, k) is None
    got = ro.load(b"\x03" * 20)
    assert got is not None and torch.equal(got[0], k)


def test_fingerprint_covers_every_identity_axis(monkeypatch):
    base = dict(content_hash="h", num_layers=2, num_heads=2, head_dim=4,
                block_size=4, dtype=torch.float32,
                device=torch.device("cpu"))
    fp = kv_fingerprint(**base)
    keys = {kvstore.fingerprint_key(fp)}
    for field, value in [("content_hash", "g"), ("num_layers", 3),
                         ("num_heads", 1), ("head_dim", 8),
                         ("block_size", 8), ("dtype", torch.bfloat16)]:
        keys.add(kvstore.fingerprint_key(kv_fingerprint(
            **dict(base, **{field: value}))))
    set_flags({"kernel_tier": "torch"})
    try:
        keys.add(kvstore.fingerprint_key(kv_fingerprint(**base)))
    finally:
        set_flags({"kernel_tier": "auto"})
    real = kbuild.source_hash
    monkeypatch.setattr(kbuild, "source_hash",
                        lambda n: real(n) + ("x" if n == "paged_attention"
                                             else ""))
    keys.add(kvstore.fingerprint_key(kv_fingerprint(**base)))
    assert len(keys) == 9
    assert fp["dtype"] == "float32" and fp["torch"] == torch.__version__


def test_fingerprint_keys_every_executable_flag():
    """The spill fingerprint keys the warm cache's flag tuple (the
    reference's kvstore.py:112-123 keys its executor's): toggling any of
    them misses."""
    from paddle_tpu_torch.serving.execcache import KEY_FLAGS
    from paddle_tpu_torch.core.flags import get_flag
    base = ("h", 2, 2, 4, 4, torch.float32, torch.device("cpu"))
    keys = {kvstore.fingerprint_key(kv_fingerprint(*base))}
    for flag in KEY_FLAGS:
        old = get_flag(flag)
        new = {bool: lambda v: not v, str: lambda v: v + "x"}[type(old)](old)
        set_flags({flag: new})
        try:
            keys.add(kvstore.fingerprint_key(kv_fingerprint(*base)))
        finally:
            set_flags({flag: old})
    assert len(keys) == 1 + len(KEY_FLAGS)


def test_resolve_store_precedence_and_manifest_pinning(lm_bundle, tmp_path,
                                                       flags_guard):
    fp = kv_fingerprint("h", 2, 2, 4, 4, torch.float32)
    assert resolve_store(None, None, fp) is None
    assert resolve_store(lm_bundle, False, fp) is None
    assert resolve_store(lm_bundle, None, fp) is None    # empty flag
    set_flags({"serving_kv_spill_dir": str(tmp_path / "flag"),
               "serving_kv_spill_bytes": 123})
    st = resolve_store(lm_bundle, None, fp)
    assert not st.readonly and st.budget_bytes == 123
    explicit = resolve_store(lm_bundle, str(tmp_path / "x"), fp)
    assert explicit.path.endswith("x") and not explicit.readonly
    set_flags({"serving_kv_spill_dir": ""})
    # a published version's kv/ wins, read-only and pinned to kv_files
    reg = ModelRegistry(str(tmp_path / "reg"))
    v = reg.publish("lm", lm_bundle, model_kind="generative",
                    kv_prompts=[PROMPT], place=fluid.CPUPlace(),
                    warm_kwargs={"gen_opts": dict(ENGINE)})
    path, _ = reg.resolve("lm", v)
    m = reg.manifest("lm", v)
    # the warm pass also exported the engine's phase programs (the prefix
    # cache on: the chunked phase too)
    tags = sorted(f.split("/")[1].split("-")[0] for f in m["warm_files"])
    assert len(m["kv_files"]) == 2 and tags == [
        "gen_chunk_b16", "gen_chunk_b8", "gen_decode_b4", "gen_prefill_b16",
        "gen_prefill_b8"]
    reg.verify("lm", v)
    eng = _engine(path, prefix_cache_blocks=16)
    assert eng.stats()["kv_store"]["readonly"]
    eng.warmup()
    before = _prefills(eng)
    toks = _drain(eng, *eng.start(PROMPT, 5))
    assert eng.stats()["kv_store"]["restores"] == 2
    assert _prefills(eng) == before
    # an artifact the manifest does not certify never loads
    m["kv_files"] = {}
    with open(os.path.join(path, "VERSION.json"), "w") as f:
        json.dump(m, f)
    eng2 = _engine(path, prefix_cache_blocks=16)
    eng2.warmup()
    assert _drain(eng2, *eng2.start(PROMPT, 5)) == toks
    assert eng2.stats()["kv_store"]["rejects"]["manifest"] >= 1


def test_restore_copies_one_stack_each_way(lm_bundle, tmp_path,
                                           flags_guard):
    """A block leaves the arena as one [layers, block_size, heads,
    head_dim] stack of K and one of V, and comes back the same way."""
    set_flags({"serving_kv_spill_dir": str(tmp_path / "spill")})
    eng = _engine(lm_bundle, prefix_cache_blocks=16)
    eng.warmup()
    _drain(eng, *eng.start(PROMPT, 5))
    b = next(iter(eng.cache._block_hash))
    k, v = eng.cache._block_kv(b)
    assert k.shape == (2, 4, 2, 4) and v.device.type == "cpu"
    np.testing.assert_array_equal(k[1].numpy(),
                                  eng.cache.k[1][b].cpu().numpy())
