"""The port's kernel autotuner (paddle_tpu_torch/ops/autotune.py) on the
CPU: the counterpart of tests/test_kernel_autotune.py.

* keys, the table's round trip, merge, digest and strict parsing;
* ``dispatch_variant``'s precedence: a pinned variant, then the attached
  table under ``kernel_tier=auto`` with ``kernel_autotune`` on (CUDA
  tensors only), then static routing; bf16 variants only under the
  ``kernel_autotune_bf16`` opt-in; an unsupported pin runs the plain chain
  and counts a fallback;
* the tuner's measurement and its candidate rules;
* the store: identity in the filename (an edited ``.cu`` misses), typed
  rejects, manifest pinning, resolution and ``attach_for_bundle``;
* one program's ``capture()`` key list is the reference's;
* ``conv_bn``'s variants on the CPU (the wrappers' plain twins): the
  128-row tile's outputs and training losses bitwise the default's, bf16
  within a loose tolerance of the plain chain;
* a registry publish with ``tune=True`` ships a manifest-pinned table that
  the engine attaches, with replies bitwise an untuned engine's.

The variants' kernels on the card are held by ``chip_smoke.py``'s phase
27 and tests/test_torch_conv_variants_card.py (``-m cuda``).
"""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import autotune as jat
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.flags import get_flag, set_flags
from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.obs.metrics import REGISTRY
from paddle_tpu_torch.ops import autotune as at
from paddle_tpu_torch.ops import cuda as tier
from paddle_tpu_torch.ops.cuda import build as kbuild
from paddle_tpu_torch.serving import InferenceEngine, ModelRegistry

FLAGS = ("kernel_tier", "kernel_autotune", "kernel_autotune_dir",
         "kernel_autotune_digest", "kernel_autotune_bf16")
CUDA = torch.device("cuda", 0)       # a device object only: nothing runs


@pytest.fixture(autouse=True)
def _guard():
    saved = {n: get_flag(n) for n in FLAGS}
    yield
    at.detach_table()
    set_flags(saved)
    tier.reset_fallback_counts()


def _counter(name, **labels):
    return int(REGISTRY.get(name).labels(**labels).value)


def test_make_key_canonical_and_key_str_stable():
    k1 = at.make_key(x=[1, 2], dtype=at.dtype_str(torch.float32), act="")
    k2 = at.make_key(act="", dtype="float32", x=(1, 2))
    assert k1 == k2 and at.key_str(k1) == at.key_str(k2)
    assert at.key_str(k1) == '[["act",""],["dtype","float32"],["x",[1,2]]]'
    assert at.dtype_str(torch.bfloat16) == "bfloat16"


def test_table_roundtrip_merge_digest_and_strict_from_doc():
    t = at.TuneTable(fingerprint={"a": 1})
    k = at.make_key(x=(1, 2))
    t.set("conv_bn", k, "pallas_db", {"pallas": 2.0, "pallas_db": 1.0})
    back = at.TuneTable.from_doc(json.loads(json.dumps(t.to_doc())))
    assert back.lookup("conv_bn", k) == "pallas_db"
    assert back.digest() == t.digest()
    other = at.TuneTable(fingerprint={"a": 1})
    other.set("conv_bn", k, "pallas")
    assert t.merge(other).lookup("conv_bn", k) == "pallas"
    for bad in ({"schema": "x"}, {"schema": "pdtpu-tune-table-v1"},
                {"schema": "pdtpu-tune-table-v1", "fingerprint": {},
                 "entries": [{"kernel": 1}]}):
        with pytest.raises(ValueError):
            at.TuneTable.from_doc(bad)


def test_dispatch_precedence():
    key = at.make_key(x=(1, 8, 8, 4))
    sup = {"jnp": True, "pallas": True, "pallas_db": True,
           "pallas_bf16": True}
    set_flags({"kernel_tier": "auto"})
    assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) == "pallas"
    assert at.dispatch_variant("conv_bn", key, sup,
                               device=torch.device("cpu")) == "jnp"
    t = at.TuneTable()
    t.set("conv_bn", key, "pallas_db")
    at.attach_table(t)
    before = _counter("paddle_tpu_kernel_autotune_selections",
                      kernel="conv_bn")
    assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) \
        == "pallas_db"
    assert _counter("paddle_tpu_kernel_autotune_selections",
                    kernel="conv_bn") == before + 1
    # the table routes CUDA tensors only; a CPU tensor keeps static routing
    assert at.dispatch_variant("conv_bn", key, sup,
                               device=torch.device("cpu")) == "jnp"
    # unsupported, autotune off, or another tier: static routing
    assert at.dispatch_variant("conv_bn", key, dict(sup, pallas_db=False),
                               device=CUDA) == "pallas"
    set_flags({"kernel_autotune": False})
    assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) == "pallas"
    set_flags({"kernel_autotune": True, "kernel_tier": "torch"})
    assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) == "jnp"
    set_flags({"kernel_tier": "auto"})
    # a bf16 entry needs the opt-in
    t.set("conv_bn", key, "pallas_bf16")
    at.attach_table(t, merge=False)
    assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) == "pallas"
    set_flags({"kernel_autotune_bf16": True})
    assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) \
        == "pallas_bf16"
    # a pin beats the table; an unsupported pin runs jnp and counts
    with at.force_variant("conv_bn", "pallas"):
        assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) \
            == "pallas"
        with at.force_variant("conv_bn", "pallas_db"):
            assert at.dispatch_variant(
                "conv_bn", key, dict(sup, pallas_db=False),
                device=CUDA) == "jnp"
        assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) \
            == "pallas"
    assert tier.fallback_counts() == {"conv_bn": 1}
    # a family with one lowering wants no kernel: no fallback on the card
    assert at.dispatch_variant("chunked_prefill_attention", key,
                               {"jnp": True}, device=CUDA) == "jnp"
    assert tier.fallback_counts() == {"conv_bn": 1}


def test_attach_detach_digest_flag_gauge_and_merge():
    a, b = at.TuneTable(), at.TuneTable()
    a.set("conv_bn", at.make_key(i=1), "pallas")
    b.set("rnn", at.make_key(i=2), "jnp")
    d1 = at.attach_table(a)
    assert get_flag("kernel_autotune_digest") == d1 == at.active_digest()
    d2 = at.attach_table(b)
    assert d2 != d1 and len(at.active_table().entries) == 2
    g = REGISTRY.get("paddle_tpu_kernel_variant_selected")
    assert g.labels(kernel="conv_bn", variant="pallas").value == 1
    at.detach_table()
    assert get_flag("kernel_autotune_digest") == "" and \
        at.active_digest() is None
    assert g.labels(kernel="conv_bn", variant="pallas").value == 0


def test_variant_allowed_capture_and_measure():
    assert at.variant_allowed("conv_bn", "pallas_db")
    assert not at.variant_allowed("conv_bn", "pallas_bf16")
    assert not at.variant_allowed("conv_bn", "nope")
    with at.capture() as keys:
        at.dispatch_variant("rnn", at.make_key(i=1),
                            {"jnp": True, "pallas": False})
    assert keys == [("rnn", at.make_key(i=1), ("jnp",))]

    calls = []

    def runner(name, s):
        def run():
            calls.append(name)
            time.sleep(s)
        return run

    def broken():
        raise RuntimeError("no")
    got = at.measure({"slow": runner("slow", 0.004),
                      "fast": runner("fast", 0.0005), "bad": broken},
                     repeats=2, inner=1)
    assert set(got) == {"slow", "fast"} and got["fast"] < got["slow"]
    # interleaved: windows alternate between the variants
    assert calls[2:6] == ["fast", "slow", "fast", "slow"]


def test_routing_is_per_engine_and_never_plain_where_the_kernel_runs():
    from paddle_tpu_torch.serving import execcache
    key = at.make_key(x=(1, 8, 8, 4))
    sup = {"jnp": True, "pallas": True, "pallas_db": True,
           "pallas_bf16": True}
    set_flags({"kernel_tier": "auto"})
    own, foreign = at.TuneTable(), at.TuneTable()
    own.set("conv_bn", key, "pallas_db")
    foreign.set("conv_bn", key, "jnp")
    at.attach_table(foreign)
    # a table naming the plain chain where the kernel runs is ignored
    assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) == "pallas"
    assert at.dispatch_variant("conv_bn", key, dict(sup, pallas=False),
                               device=CUDA) == "jnp"
    feeds = {"x": torch.zeros(2, 3)}
    with at.routing(own):
        assert at.dispatch_variant("conv_bn", key, sup, device=CUDA) \
            == "pallas_db"
        assert at.active_digest() == own.digest()
        fp = execcache.fingerprint("h", "t", feeds, ["y"])
        assert fp["flags"]["kernel_autotune_digest"] == own.digest()
    assert at.active_digest() == foreign.digest() == \
        execcache.fingerprint("h", "t", feeds, ["y"])["flags"][
            "kernel_autotune_digest"]
    with at.routing(None):
        assert at.active_digest() == foreign.digest()


def test_tuner_candidates_bf16_gate_and_broken_build():
    reg = at.VariantRegistry()
    reg.register("k", "jnp", lambda key: (lambda: time.sleep(0.003)))
    reg.register("k", "pallas", lambda key: (lambda: None))
    reg.register("k", "pallas_bf16", lambda key: (lambda: None), bf16=True)
    reg.register("one", "jnp", lambda key: None)
    reg.register("brk", "jnp", lambda key: None)
    reg.register("brk", "pallas", lambda key: 1 / 0)
    # the plain chain is the fastest here, but the kernel runs the key
    reg.register("slow", "jnp", lambda key: (lambda: None))
    reg.register("slow", "pallas", lambda key: (lambda: time.sleep(0.003)))
    key, other = at.make_key(i=1), at.make_key(i=2)
    captured = [("k", key, ("jnp", "pallas", "pallas_bf16")),
                ("k", key, ("jnp", "pallas")),
                ("one", key, ("jnp",)), ("brk", key, ("jnp", "pallas")),
                ("slow", key, ("jnp", "pallas")), ("slow", other, ("jnp",))]
    t = at.Tuner(repeats=2, inner=1, registry=reg).tune(captured)
    assert t.lookup("k", key) == "pallas"
    assert "pallas_bf16" not in t.entries[("k", at.key_str(key))][
        "timings_ms"]
    assert t.lookup("one", key) == "jnp"
    # no runner can win: the kernel's static route where it runs
    assert t.lookup("brk", key) == "pallas"
    # a hand-written variant wins where the kernel runs; jnp is timed
    timings = t.entries[("slow", at.key_str(key))]["timings_ms"]
    assert t.lookup("slow", key) == "pallas" and \
        timings["jnp"] < timings["pallas"]
    assert t.lookup("slow", other) == "jnp"


def test_store_roundtrip_rejects_and_manifest_pinning(tmp_path):
    store = at.TuneStore(str(tmp_path / "tune"))
    t = at.TuneTable()
    t.set("conv_bn", at.make_key(i=1), "pallas")
    path = store.save(t)
    assert os.path.basename(path).startswith("table-")
    assert store.load().digest() == t.digest()
    assert store.touched() == [os.path.basename(path)]
    with open(path, "rb") as f:
        raw = f.read()

    def rejects():
        return {r: _counter("paddle_tpu_kernel_autotune_rejects", reason=r)
                for r in at.REJECT_REASONS}

    def envelope(blob):
        return at._MAGIC + hashlib.sha256(blob).hexdigest().encode() + \
            b"\n" + blob
    blob = raw[raw.index(b"\n", len(at._MAGIC)) + 1:]
    doc = json.loads(blob)
    cases = [
        ("format", raw[:-3]),
        ("format", b"JUNK" + raw),
        ("deserialize", envelope(b"{not json")),
        ("fingerprint", envelope(json.dumps(
            dict(doc, fingerprint=dict(doc["fingerprint"], device="x")))
            .encode())),
    ]
    for reason, bad in cases:
        before = rejects()
        with open(path, "wb") as f:
            f.write(bad)
        assert store.load() is None
        assert rejects()[reason] == before[reason] + 1, reason
    with open(path, "wb") as f:
        f.write(raw)
    pinned = at.TuneStore(str(tmp_path / "tune"), readonly=True,
                          expected_digests={os.path.basename(path):
                                            hashlib.sha256(raw).hexdigest()})
    assert pinned.load() is not None and pinned.save(t) is None
    unlisted = at.TuneStore(str(tmp_path / "tune"), readonly=True,
                            expected_digests={})
    before = rejects()["manifest"]
    assert unlisted.load() is None
    assert rejects()["manifest"] == before + 1


def test_edited_kernel_source_misses(tmp_path, monkeypatch):
    store = at.TuneStore(str(tmp_path / "tune"))
    store.save(at.TuneTable())
    assert store.load() is not None
    real = kbuild.source_hash
    monkeypatch.setattr(kbuild, "source_hash",
                        lambda n: real(n) + ("x" if n == "conv_affine"
                                             else ""))
    assert store.load() is None                # a filename miss, silent
    fp = at.table_fingerprint()
    assert fp["kernel_sources"]["conv_affine"].endswith("x")
    assert {"torch", "cuda", "device", "capability",
            "kernel_tier"} <= set(fp)


def test_resolve_store_precedence_and_attach_for_bundle(tmp_path):
    set_flags({"kernel_tier": "auto"})
    local = tmp_path / "local"
    at.TuneStore(str(local)).save(at.TuneTable())
    assert at.resolve_store(None) is None
    set_flags({"kernel_autotune_dir": str(local)})
    st = at.resolve_store(None)
    assert st.readonly and st.path == str(local)
    assert at.attach_for_bundle(None) == at.active_digest()
    at.detach_table()
    set_flags({"kernel_autotune": False})
    assert at.attach_for_bundle(None) is None
    set_flags({"kernel_autotune": True, "kernel_tier": "torch"})
    assert at.attach_for_bundle(None) is None


def _conv_program(fl, test=True):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 3
    with fl.program_guard(main, startup):
        img = fl.layers.data("img", shape=[8, 8, 4])
        label = fl.layers.data("label", shape=[1], dtype="int64")
        c = fl.layers.conv2d(img, 8, 3, padding=1, bias_attr=False,
                             data_format="NHWC")
        b = fl.layers.batch_norm(c, act="relu", data_layout="NHWC")
        c2 = fl.layers.conv2d(b, 8, 1, bias_attr=False, data_format="NHWC")
        b2 = fl.layers.batch_norm(c2, data_layout="NHWC")
        pool = fl.layers.pool2d(b2, pool_type="avg", global_pooling=True,
                                data_format="NHWC")
        logits = fl.layers.fc(pool, size=4)
        loss = fl.layers.mean(
            fl.layers.softmax_with_cross_entropy(logits, label))
        infer = main.clone(for_test=True)
        fl.fuse_conv_bn(main)
        fl.optimizer.Momentum(0.05, 0.9).minimize(loss, startup)
    fl.fuse_conv_bn(infer)
    return main, startup, infer, logits, loss


def _feed():
    rng = np.random.RandomState(0)
    return {"img": rng.normal(0, 1, (2, 8, 8, 4)).astype("float32"),
            "label": rng.randint(0, 4, (2, 1)).astype("int64")}


def test_capture_key_list_is_the_references():
    """One program captured in both packages gives the same (kernel, key)
    list: the fused chains' conv_bn keys (training and the test clone) and
    the optimizer's. Which variants each supports may differ (the
    reference's predicates keep TPU budgets), so only the keys are held."""
    feed = _feed()
    jmain, jstart, jinfer, jlogits, jloss = _conv_program(jfluid)
    jexe = jfluid.Executor()
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    with jat.capture() as jkeys:
        jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        jexe.run(jinfer, feed=feed, fetch_list=[jlogits], scope=jscope)
    framework.reset_unique_name()
    main, start, infer, logits, loss = _conv_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(start, scope=scope)
    with at.capture() as keys:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        exe.run(infer, feed=feed, fetch_list=[logits], scope=scope)
    got = [(k, at.key_str(key)) for k, key, _ in keys]
    want = [(k, jat.key_str(key)) for k, key, _ in jkeys]
    assert [k for k, _ in got].count("conv_bn") == 4
    assert got == want


def _losses(variant, steps=2):
    set_flags({"kernel_tier": "cuda"})
    framework.reset_unique_name()
    main, startup, _infer, _logits, loss = _conv_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with at.force_variant("conv_bn", variant):
        return [float(exe.run(main, feed=_feed(), fetch_list=[loss],
                              scope=scope)[0]) for _ in range(steps)]


def test_conv_bn_variants_on_the_cpu_twins():
    set_flags({"kernel_tier": "cuda"})
    framework.reset_unique_name()
    _main, startup, infer, logits, _loss = _conv_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = _feed()

    def out(variant):
        with at.force_variant("conv_bn", variant):
            return exe.run(infer, feed=feed, fetch_list=[logits],
                           scope=scope)[0]
    ref, pl, db, bf = (out(v) for v in ("jnp", "pallas", "pallas_db",
                                        "pallas_bf16"))
    np.testing.assert_allclose(pl, ref, rtol=1e-4, atol=1e-5)
    assert np.array_equal(db, pl)
    np.testing.assert_allclose(bf, ref, rtol=0.1, atol=0.05)
    assert tier.fallback_counts() == {}
    assert _losses("pallas_db") == _losses("pallas")


def test_publish_tune_ships_pinned_table_and_replies_unchanged(tmp_path):
    set_flags({"kernel_tier": "auto"})
    framework.reset_unique_name()
    _main, startup, infer, logits, _loss = _conv_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "bundle")
    fluid.io.save_inference_model(d, ["img"], [logits], exe, infer,
                                  scope=scope)
    reg = ModelRegistry(str(tmp_path / "reg"))
    v = reg.publish("net", d, tune={"repeats": 1, "inner": 1},
                    place=fluid.CPUPlace(), warm_kwargs={"buckets": [2]})
    path, _ = reg.resolve("net", v)
    m = reg.manifest("net", v)
    assert len(m["tune_files"]) == 1 and m["kernel_tier"] == "torch"
    reg.verify("net", v)
    table = at.resolve_store(path).load()
    kinds = {k for k, _ in table.entries}
    assert "conv_bn" in kinds
    at.detach_table()
    x = _feed()["img"]
    untuned = InferenceEngine(d, place=fluid.CPUPlace(), buckets=[2])
    untuned.warmup()
    want = untuned.infer({"img": x})[0]
    eng = InferenceEngine(path, place=fluid.CPUPlace(), buckets=[2])
    eng.warmup()
    # the engine routes by its own table; nothing leaks to the process or
    # to an engine whose bundle has none
    assert eng.stats()["tune_digest"] == table.digest()
    assert at.active_digest() is None and \
        get_flag("kernel_autotune_digest") == ""
    assert untuned.stats()["tune_digest"] is None
    assert np.array_equal(eng.infer({"img": x})[0], want)
