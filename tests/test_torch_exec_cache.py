"""The port's warm-executable cache (paddle_tpu_torch/serving/execcache.py)
on the CPU: the counterpart of tests/test_exec_cache.py.

A warm executable is the ``torch.export`` program of one (bucket, fetch
list). Held here:

* warm replies equal cold replies bitwise (an MLP, and a fused conv net
  whose artifact keeps ``conv_affine`` as its operator), the fill exports
  and saves, the hit loads and its warmup reports 0 first dispatches;
* the fingerprint misses on every field: bundle bytes, tag, feed dtype and
  shape, fetch order, each routing flag, each TF32 switch, the torch and
  CUDA versions, a kernel library's source;
* corrupt, truncated and foreign artifacts reject with their typed reason
  and the engine runs its op loop instead, bitwise; an executable that
  fails to run rejects as ``run_failed``;
* a published version's ``warm/`` dir loads read-only, pinned to the
  manifest's ``warm_files``; ``verify`` catches a tampered artifact;
* the cache resolves explicit, then published, then the flag's dir;
* ``ModelServer(exec_cache=...)`` serves through it;
* ``fluid/aot.py`` records the exporting process's TF32 switches and runs
  the artifact under them.

The reference's six seed-failing warm-path tests assert that a warm
JAX engine compiles nothing on this CPU (XLA:CPU's loader refuses the
artifacts here); the port keeps its own contract and asserts nothing of
the reference's counts.
"""

import hashlib
import json
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.flags import get_flag, set_flags
from paddle_tpu_torch.fluid import aot
from paddle_tpu_torch.obs import perf
from paddle_tpu_torch.ops.cuda import build as kbuild
from paddle_tpu_torch.serving import (ExecCache, InferClient,
                                      InferenceEngine, ModelRegistry,
                                      ModelServer, execcache)
from paddle_tpu_torch.testing.models import resnet

FLAGS = ("kernel_tier", "serving_exec_cache", "serving_exec_cache_dir")
BUCKETS = "1,4"


@pytest.fixture(autouse=True)
def _guard():
    saved = {n: get_flag(n) for n in FLAGS}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    yield
    set_flags(saved)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


def _mlp_bundle(path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6])
        h = fluid.layers.fc(x, 8, act="relu")
        y = fluid.layers.fc(h, 3, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(path), ["x"], [y], exe, main,
                                  scope=scope)
    return str(path), {"x": np.random.RandomState(0).normal(
        0, 1, (3, 6)).astype("float32")}


def _conv_bundle(path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[16, 16, 4])
        logits = resnet(img, 10, counts=(1, 1, 1, 1), base=4)
    fluid.fuse_conv_bn(main)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(path), ["img"], [logits], exe, main,
                                  scope=scope)
    return str(path), {"img": np.random.RandomState(1).normal(
        0, 1, (3, 16, 16, 4)).astype("float32")}


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    return _mlp_bundle(tmp_path_factory.mktemp("ec") / "mlp")


def _engine(d, cache, **kw):
    return InferenceEngine(d, place=fluid.CPUPlace(), buckets=BUCKETS,
                           exec_cache=cache, **kw)


def _cold(d, feed):
    eng = _engine(d, False)
    eng.warmup()
    return eng.infer(feed)


@pytest.mark.parametrize("model", ["mlp", "conv"])
def test_warm_replies_bitwise_cold(tmp_path, model):
    set_flags({"kernel_tier": "cuda"})       # the conv net's kernel route
    d, feed = (_mlp_bundle if model == "mlp" else _conv_bundle)(
        tmp_path / model)
    want = _cold(d, feed)
    perf.COMPILE_LOG.clear()
    cache = str(tmp_path / "cache")
    fill = _engine(d, cache)
    assert fill.warmup() == 2                 # exported, then dispatched
    st = fill.stats()["exec_cache"]
    assert st["saves"] == 2 and st["misses"] == 2
    assert len(perf.COMPILE_LOG.records(site="exec_cache_save")) == 2
    hit = _engine(d, cache)
    assert hit.warmup() == 0                  # loaded: nothing built
    st = hit.stats()
    assert st["exec_cache"]["hits"] == 2 and st["warm_loaded"] == 2
    assert len(perf.COMPILE_LOG.records(site="exec_cache_load")) == 2
    for eng in (fill, hit):
        for got, w in zip(eng.infer(feed), want):
            assert np.array_equal(got, w)
    if model == "conv":
        art = ExecCache(cache).artifacts()[0]
        with open(os.path.join(cache, art), "rb") as f:
            assert b"conv_affine" in f.read()   # the operator, kept whole


def _fp(**over):
    feeds = over.pop("feeds", {"x": torch.zeros((4, 6))})
    base = dict(content_hash="h", tag="infer_b4", feeds=feeds,
                fetch_names=["a", "b"], device=torch.device("cpu"))
    base.update(over)
    return execcache.fingerprint(**base)


def test_fingerprint_misses_on_every_field(monkeypatch):
    keys = {execcache.fingerprint_key(_fp())}
    keys.add(execcache.fingerprint_key(_fp(content_hash="g")))
    keys.add(execcache.fingerprint_key(_fp(tag="infer_b8")))
    keys.add(execcache.fingerprint_key(_fp(
        feeds={"x": torch.zeros((4, 6), dtype=torch.float64)})))
    keys.add(execcache.fingerprint_key(_fp(
        feeds={"x": torch.zeros((4, 7))})))
    keys.add(execcache.fingerprint_key(_fp(fetch_names=["b", "a"])))
    n = len(keys)
    toggles = [("kernel_tier", "torch"), ("kernel_autotune", False),
               ("kernel_autotune_digest", "abc"),
               ("kernel_autotune_bf16", True),
               ("conv_space_to_depth", True), ("conv_1x1_grad_as_dot", True),
               ("use_pallas_rnn", True), ("use_pallas_ctc", True),
               ("bn_fusion_barrier", True), ("bn_fusion_barrier_fwd", True),
               ("bn_fusion_barrier_bwd", True)]
    assert [f for f, _ in toggles] == list(execcache.KEY_FLAGS)
    for flag, value in toggles:
        old = get_flag(flag)
        set_flags({flag: value})
        try:
            keys.add(execcache.fingerprint_key(_fp()))
        finally:
            set_flags({flag: old})
    assert len(keys) == n + len(toggles)
    torch.backends.cuda.matmul.allow_tf32 = \
        not torch.backends.cuda.matmul.allow_tf32
    keys.add(execcache.fingerprint_key(_fp()))
    torch.backends.cudnn.allow_tf32 = not torch.backends.cudnn.allow_tf32
    keys.add(execcache.fingerprint_key(_fp()))
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    keys.add(execcache.fingerprint_key(_fp()))
    monkeypatch.setattr(torch.version, "cuda", "0.0")
    keys.add(execcache.fingerprint_key(_fp()))
    real = kbuild.source_hash
    monkeypatch.setattr(kbuild, "source_hash",
                        lambda name: real(name) + ("!" if name == "conv_bn_bwd"
                                                   else ""))
    keys.add(execcache.fingerprint_key(_fp()))
    assert len(keys) == n + len(toggles) + 5
    fp = _fp()
    assert fp["feeds"] == {"x": ["float32", [4, 6]]}
    assert set(fp["kernel_sources"]) == set(kbuild.kernel_libraries())


def _rejects(eng, reason):
    return eng.stats()["exec_cache"]["rejects"][reason]


def _envelope(blob):
    return execcache._MAGIC + hashlib.sha256(blob).hexdigest().encode() \
        + b"\n" + blob


@pytest.mark.parametrize("damage,reason", [
    ("bitflip", "format"), ("truncate", "format"),
    ("foreign", "format"), ("fingerprint", "fingerprint"),
    ("payload", "deserialize")])
def test_bad_artifacts_reject_typed_and_run_eagerly(tmp_path, mlp, damage,
                                                    reason):
    d, feed = mlp
    want = _cold(d, feed)
    cache = str(tmp_path / "cache")
    _engine(d, cache).warmup()
    for name in ExecCache(cache).artifacts():
        path = os.path.join(cache, name)
        with open(path, "rb") as f:
            raw = f.read()
        blob = raw[raw.index(b"\n", len(execcache._MAGIC)) + 1:]
        if damage == "bitflip":
            bad = raw[:-9] + bytes([raw[-9] ^ 0x20]) + raw[-8:]
        elif damage == "truncate":
            bad = raw[:len(raw) // 3]
        elif damage == "foreign":
            # the reference's envelope around the same payload
            bad = b"PDTPUEXEC1\n" + raw[len(execcache._MAGIC):]
        elif damage == "fingerprint":
            doc = pickle.loads(blob)
            doc["fingerprint"] = dict(doc["fingerprint"], device="other")
            bad = _envelope(pickle.dumps(doc))
        else:
            doc = pickle.loads(blob)
            doc["payload"] = b"not a torch.export archive"
            bad = _envelope(pickle.dumps(doc))
        with open(path, "wb") as f:
            f.write(bad)
    eng = _engine(d, ExecCache(cache, readonly=True))
    assert eng.warmup() == 2                  # both buckets ran the op loop
    assert _rejects(eng, reason) == 2
    for got, w in zip(eng.infer(feed), want):
        assert np.array_equal(got, w)


def test_run_failed_falls_back_on_the_same_route(tmp_path, mlp):
    d, feed = mlp
    want = _cold(d, feed)
    cache = str(tmp_path / "cache")
    _engine(d, cache).warmup()
    eng = _engine(d, cache)
    assert eng.warmup() == 0

    def broken(*args):
        raise RuntimeError("planted")
    for entry in eng._warm_execs.values():
        entry.module = broken
    got = eng.infer(feed)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    st = eng.stats()
    assert st["exec_cache"]["rejects"]["run_failed"] == 1
    assert st["hot_recompiles"] == 1 and st["warm_loaded"] == 1


def test_published_warm_dir_is_pinned_verified_and_collected(tmp_path, mlp):
    d, feed = mlp
    want = _cold(d, feed)
    reg = ModelRegistry(str(tmp_path / "reg"))
    v = reg.publish("mlp", d, warm_cache=True, place=fluid.CPUPlace(),
                    warm_kwargs={"buckets": BUCKETS})
    path, _ = reg.resolve("mlp", v)
    m = reg.manifest("mlp", v)
    assert len(m["warm_files"]) == 2 and m["kernel_tier"] == "torch"
    assert reg.warm("mlp", v, buckets=BUCKETS, place=fluid.CPUPlace()) \
        == sorted(m["warm_files"])             # idempotent re-warm
    eng = InferenceEngine(path, place=fluid.CPUPlace(), buckets=BUCKETS)
    assert eng.warmup() == 0
    assert eng.stats()["exec_cache"]["readonly"]
    assert all(np.array_equal(g, w) for g, w in zip(eng.infer(feed), want))
    # a tampered artifact: verify() catches it, the engine refuses it
    rel = sorted(m["warm_files"])[0]
    with open(os.path.join(path, rel), "ab") as f:
        f.write(b"x")
    with pytest.raises(ValueError, match="corrupt"):
        reg.verify("mlp", v)
    eng2 = InferenceEngine(path, place=fluid.CPUPlace(), buckets=BUCKETS)
    assert eng2.warmup() == 1
    assert _rejects(eng2, "manifest") == 1
    assert all(np.array_equal(g, w) for g, w in zip(eng2.infer(feed), want))
    reg.publish("mlp", d)
    reg.publish("mlp", d)
    assert reg.gc("mlp", keep_latest=1) == [v]
    assert not os.path.exists(path)


def test_resolve_cache_precedence_and_kill_switch(tmp_path, mlp):
    d, _ = mlp
    assert execcache.resolve_cache(d) is None          # no flag, no warm/
    assert execcache.resolve_cache(None, None) is None
    assert execcache.resolve_cache(d, False) is None
    explicit = execcache.resolve_cache(d, str(tmp_path / "x"))
    assert not explicit.readonly
    set_flags({"serving_exec_cache_dir": str(tmp_path / "local")})
    assert execcache.resolve_cache(d).path == str(tmp_path / "local")
    set_flags({"serving_exec_cache": False})
    assert execcache.resolve_cache(d) is None
    # a warm engine under the kill switch runs its op loop
    assert _engine(d, None).warmup() == 2


def test_model_server_serves_through_the_cache(tmp_path, mlp):
    d, feed = mlp
    want = _cold(d, feed)
    cache = str(tmp_path / "cache")
    _engine(d, cache).warmup()
    server = ModelServer(d, buckets=BUCKETS, exec_cache=cache,
                         engine=_engine(d, cache))
    server.start()
    try:
        with InferClient(server.address) as c:
            got = c.infer(feed)
            st = c.stats()
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert st["engine"]["warm_loaded"] == 2
        assert st["engine"]["exec_cache"]["hits"] == 2
    finally:
        server.shutdown()


def test_aot_manifest_records_tf32_and_runs_under_it(tmp_path, mlp):
    d, feed = mlp
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    program, feeds, fetches = fluid.io.load_inference_model(d, exe,
                                                            scope=scope)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    manifest = aot.export_inference_artifact(
        str(tmp_path / "art"), feeds, fetches, exe, main_program=program,
        scope=scope)
    assert manifest["tf32"] == {"matmul": False, "cudnn": True}
    with open(tmp_path / "art" / aot.MANIFEST_FILENAME) as f:
        assert json.load(f)["tf32"] == manifest["tf32"]
    art = aot.load_inference_artifact(str(tmp_path / "art"))
    seen = []
    inner = art._module
    art._module = lambda *a: (seen.append(
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)), inner(*a))[1]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = False
    art.run(feed)
    assert seen == [(False, True)]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, False)


# ---------------------------------------------------------------------------
# the generation engine's phase programs
# ---------------------------------------------------------------------------

GEN_OPTS = dict(max_seqs=2, block_size=4, num_blocks=32, max_len=32,
                prefill_buckets=(8, 16))
PROMPTS = ([3, 5, 7], [3, 5, 7, 9, 11, 2], [1, 2, 3, 4, 5, 6, 7, 8, 9])


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    from paddle_tpu_torch.testing.models import export_tiny_lm

    d = str(tmp_path_factory.mktemp("gen") / "lm")
    export_tiny_lm(d, place=fluid.CPUPlace(), vocab=17, emb=8, heads=2,
                   n_layers=2, max_pos=64, seed=13)
    return d


def _gen(d, cache, **kw):
    from paddle_tpu_torch.serving.generate import GenerationEngine

    opts = dict(GEN_OPTS)
    opts.update(kw)
    return GenerationEngine(d, place=fluid.CPUPlace(), exec_cache=cache,
                            **opts)


def _streams(eng, sampling, prompts=PROMPTS, max_new=8):
    """Every prompt's token stream, the requests joining one running
    batch as slots free up (the continuous route)."""
    out = {i: [] for i in range(len(prompts))}
    pending = list(enumerate(prompts))
    live = {}
    while pending or live:
        while pending and eng.active_sequences < eng.max_seqs:
            i, p = pending.pop(0)
            h, toks, fin = eng.start(p, max_new, sampling)
            out[i] += toks
            if not fin:
                live[h] = i
        for h, toks, fin in eng.step():
            out[live[h]] += toks
            if fin:
                del live[h]
    return [out[i] for i in range(len(prompts))]


def test_generation_warm_parity_and_zero_records(tmp_path, lm):
    """A registry version warmed with gen_opts holds one exported program
    per (phase, bucket); an engine on it loads them all (warmup reports 0
    and adds no compile record but the loads'), and its token streams
    equal the op loop's and the reference engine's."""
    from paddle_tpu.serving.generate import GenerationEngine as JEngine

    reg = ModelRegistry(str(tmp_path / "registry"))
    v = reg.publish("lm", lm, model_kind="generative")
    path, v = reg.resolve("lm", v)
    cold = _gen(path, None)
    assert cold.warmup() == 3                  # nothing published yet
    files = reg.warm("lm", v, gen_opts=GEN_OPTS, place=fluid.CPUPlace())
    tags = sorted(f.split("/")[1].split("-")[0] for f in files)
    assert tags == ["gen_decode_b2", "gen_prefill_b16", "gen_prefill_b8"]
    reg.verify("lm", v)
    before = perf.COMPILE_LOG.stats()["count"]
    warm = _gen(path, None)
    assert warm.warmup() == 0
    st = warm.stats()
    assert st["exec_cache"]["readonly"] and st["warm_loaded"] == 3
    assert perf.COMPILE_LOG.stats()["count"] - before == 3
    assert len([r for r in perf.COMPILE_LOG.records()
                if r.seq > before and r.site != "exec_cache_load"]) == 0
    ref = JEngine(lm, **GEN_OPTS)
    ref.warmup()
    for sampling in ({"mode": "greedy"},
                     {"mode": "topk", "seed": 3, "top_k": 4}):
        want = _streams(cold, sampling)
        assert _streams(warm, sampling) == want
        assert _streams(ref, sampling) == want
    assert warm.hot_recompiles == 0
    assert warm.stats()["exec_cache"]["rejects"]["run_failed"] == 0


def test_generation_run_failed_counts_as_hot_recompile(tmp_path, lm):
    """A loaded phase program that raises at dispatch after warmup: a
    ``run_failed`` reject, one hot recompile, and the op loop answers with
    the same tokens."""
    cache = str(tmp_path / "cache")
    _gen(lm, cache).warmup()
    eng = _gen(lm, cache)
    assert eng.warmup() == 0 and eng.stats()["warm_loaded"] == 3

    class _Boom:
        source = "cache"

        def run(self, *a, **k):
            raise RuntimeError("deserialized but unrunnable")

    eng._warm_execs[("decode", GEN_OPTS["max_seqs"])] = _Boom()
    want = _streams(_gen(lm, False), {"mode": "greedy"})
    assert _streams(eng, {"mode": "greedy"}) == want
    st = eng.stats()
    assert st["exec_cache"]["rejects"]["run_failed"] == 1
    assert eng.hot_recompiles == 1
    assert st["warm_loaded"] == 2


@pytest.mark.parametrize("tier,donate,partial", [
    ("auto", True, False), ("cuda", True, False), ("cuda", False, True)],
    ids=["plain-donated", "kernel-donated", "kernel-cloned-chunked"])
def test_exported_phase_programs_match_the_op_loop(tmp_path, lm, tier,
                                                   donate, partial):
    """Every phase program exported, then loaded by a fresh engine: token
    streams bitwise the op loop's, on both routes (under ``cuda`` the
    decode program keeps the paged-attention operator, whose plain version
    runs on the CPU), with the arena donated or cloned, and with the
    prefix cache and chunked prefill on (the chunked phase exported
    too)."""
    from paddle_tpu_torch.ops.cuda import paged_attention as pa

    set_flags({"kernel_tier": tier})
    kw = dict(donate_arena=donate)
    prompts = PROMPTS
    if partial:
        kw.update(prefix_cache_blocks=16, prefill_chunk=4)
        prompts = PROMPTS + ([3, 5, 7, 9, 11, 2, 4, 6],)
    cache = str(tmp_path / "cache")
    fill = _gen(lm, cache, **kw)
    assert fill.warmup() == (5 if partial else 3)
    warm = _gen(lm, cache, **kw)
    assert warm.warmup() == 0
    eager = _gen(lm, False, **kw)
    eager.warmup()
    for sampling in ({"mode": "greedy"},
                     {"mode": "topk", "seed": 5, "top_k": 3}):
        want = _streams(eager, sampling, prompts)
        assert _streams(warm, sampling, prompts) == want
        assert _streams(fill, sampling, prompts) == want
    assert warm.stats()["exec_cache"]["rejects"]["run_failed"] == 0
    assert warm.hot_recompiles == 0
    decode = [n for n in ExecCache(cache).artifacts()
              if n.startswith("gen_decode")]
    with open(os.path.join(cache, decode[0]), "rb") as f:
        raw = f.read()
    assert b"paged_kv_write" in raw
    assert (b"paddle_tpu_torch.paged_attention" in raw) == (tier == "cuda")
    # the operator's CPU path is the plain version, counted as no launch
    assert pa.launches["paged_attention"] == 0
