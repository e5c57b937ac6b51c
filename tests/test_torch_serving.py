"""The port's InferenceEngine against the reference's, on one bundle.

The bundle is a narrow ResNet (stage depths 1,1,1,1, base width 8, 32x32
images, 10 classes, softmax fetch) saved by the reference package with
seeded, non-trivial batch-norm statistics. Both engines serve it from the
same directory; the port also runs its kernel route (kernel_tier=cuda, whose
wrapper runs the plain version on CPU tensors) and must route exactly the
chains the reference routes to its Pallas kernel.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import io as jio
from paddle_tpu.ops import pallas as jtier
from paddle_tpu.serving import InferenceEngine as JaxEngine
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import conv_bn as tcbk
from paddle_tpu_torch.serving import InferenceEngine, parse_buckets
from paddle_tpu_torch.testing.models import resnet

# float32 through 17 convs, softmax replies: the packages order conv sums
# differently, which moves the replies by float32 roundings
TOL = dict(rtol=1e-4, atol=1e-5)
BUCKETS = [1, 2, 4]


@pytest.fixture(autouse=True)
def _fresh():
    tframework.switch_main_program(tframework.Program())
    tframework.switch_startup_program(tframework.Program())
    tframework.reset_unique_name()
    ttier.reset_fallback_counts()
    yield
    tfluid.set_flags({"kernel_tier": "auto"})
    jfluid.set_flags({"kernel_tier": "auto"})
    ttier.reset_fallback_counts()
    jtier.reset_fallback_counts()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A reference-saved narrow ResNet bundle with seeded BN statistics."""
    from paddle_tpu.fluid import framework as jframework
    jframework.reset_unique_name()
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 11
    with jfluid.program_guard(main, startup):
        img = jfluid.layers.data("img", shape=[32, 32, 3])
        prob = jfluid.layers.softmax(resnet(img, 10, counts=(1, 1, 1, 1),
                                            base=8, layers=jfluid.layers))
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    for op in main.global_block().ops:
        if op.type == "batch_norm":
            c = np.asarray(scope.find_var(op.input("Scale")[0])).shape[0]
            for slot, v in (("Scale", rng.uniform(0.5, 1.5, c)),
                            ("Bias", rng.normal(0, 0.2, c)),
                            ("Mean", rng.normal(0, 0.2, c)),
                            ("Variance", rng.uniform(0.5, 2.0, c))):
                scope.set(op.input(slot)[0], v.astype("float32"))
    assert jfluid.fuse_conv_bn(main) == 17
    d = str(tmp_path_factory.mktemp("serving") / "resnet_narrow")
    jio.save_inference_model(d, ["img"], [prob], exe, main_program=main,
                             scope=scope)
    return d


def _images(n, seed=0):
    return np.random.RandomState(seed).normal(
        0, 1, (n, 32, 32, 3)).astype("float32")


def _reference_replies(bundle, sizes):
    jfluid.set_flags({"kernel_tier": "jnp"})
    eng = JaxEngine(bundle, buckets=BUCKETS, exec_cache=False)
    return {n: eng.infer({"img": _images(n, seed=n)})[0] for n in sizes}


@pytest.mark.parametrize("tier", ["auto", "cuda"])
def test_engines_agree_on_one_bundle(bundle, tier):
    """Batches 1 and 3 (padded to buckets 1 and 4) and 6 (chunked 4 + 2)."""
    sizes = (1, 3, 6)
    want = _reference_replies(bundle, sizes)
    tfluid.set_flags({"kernel_tier": tier})
    eng = InferenceEngine(bundle, place=tfluid.CPUPlace(), buckets=BUCKETS)
    for n in sizes:
        got, = eng.infer({"img": _images(n, seed=n)})
        assert got.shape == (n, 10)
        np.testing.assert_allclose(got, want[n], **TOL, err_msg=f"batch {n}")
    stats = eng.stats()
    assert stats["kernel_tier"] == ("cuda" if tier == "cuda" else "torch")
    # the first dispatch of a bucket counts as its compile, as the
    # reference counts one; bucket 4's second dispatch is a hit
    assert stats["per_bucket"] == {
        1: {"dispatches": 1, "compiles": 1, "hits": 0},
        2: {"dispatches": 1, "compiles": 1, "hits": 0},
        4: {"dispatches": 2, "compiles": 1, "hits": 1}}
    assert stats["hot_recompiles"] == 0 and not stats["warmed"]


def test_kernel_routing_matches_reference_pallas_tier(bundle, monkeypatch):
    """17 fused chains: 13 to conv_affine, 4 (the 7x7/s2 stem and the three
    3x3/s2 convs) to the plain chain — the reference's Pallas tier counts the
    same 4 fallbacks on the same bundle, and answers the same."""
    calls = []
    real = tcbk.conv_affine

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tcbk, "conv_affine", spy)
    tfluid.set_flags({"kernel_tier": "cuda"})
    eng = InferenceEngine(bundle, place=tfluid.CPUPlace(), buckets=BUCKETS)
    x = _images(2, seed=4)
    got, = eng.infer({"img": x})
    assert len(calls) == 13
    assert ttier.fallback_counts() == {"conv_bn": 4}
    assert tcbk.launches["conv_affine"] == 0, \
        "CPU tensors never launch the kernel"

    jtier.reset_fallback_counts()
    jfluid.set_flags({"kernel_tier": "pallas"})
    jeng = JaxEngine(bundle, buckets=[2], exec_cache=False)
    want, = jeng.infer({"img": x})
    assert jtier.fallback_counts() == ttier.fallback_counts()
    np.testing.assert_allclose(got, want, **TOL)


def test_bucket_padding_trim_and_warmup(bundle):
    eng = InferenceEngine(bundle, place=tfluid.CPUPlace(), buckets=BUCKETS)
    assert [eng.bucket_for(n) for n in (1, 2, 3, 4, 9)] == [1, 2, 4, 4, 4]
    assert eng.warmup() == len(BUCKETS)
    x = _images(4, seed=5)
    full, = eng.infer({"img": x})
    part, = eng.infer({"img": x[:3]})       # padded with copies of row 2
    np.testing.assert_allclose(part, full[:3], rtol=1e-6, atol=1e-7)
    chunked, = eng.infer({"img": np.concatenate([x, x[:1]])})
    np.testing.assert_allclose(chunked[:4], full, rtol=1e-6, atol=1e-7)
    assert chunked.shape == (5, 10)
    stats = eng.stats()
    assert stats["buckets"] == BUCKETS and stats["warmed"]
    assert stats["per_bucket"][4]["dispatches"] == 1 + 3
    assert stats["dispatches"] == 3 + 4
    assert set(stats["kernel_launches"]) == {"conv_affine"}


def test_fetch_that_is_not_per_row_is_rejected(bundle):
    eng = InferenceEngine(bundle, place=tfluid.CPUPlace(), buckets=BUCKETS)
    fc_w = next(op.input("Y")[0] for op in eng.program.global_block().ops
                if op.type == "mul")
    with pytest.raises(ValueError, match="not per-row"):
        eng.infer({"img": _images(2)}, fetch_list=[fc_w])


def test_bad_requests_and_buckets_raise(bundle):
    eng = InferenceEngine(bundle, place=tfluid.CPUPlace(), buckets=BUCKETS)
    with pytest.raises(ValueError, match="missing"):
        eng.infer({})
    with pytest.raises(ValueError, match="empty"):
        eng.infer({"img": _images(0)})
    assert parse_buckets("8,1,2,2") == [1, 2, 8]
    for bad in ("", "1,x", "0,2", [-1]):
        with pytest.raises(ValueError):
            parse_buckets(bad)


def test_default_place_is_the_card(bundle):
    """Without a CPUPlace the engine and the executor want cuda:0; with no
    card they raise instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        InferenceEngine(bundle)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        tfluid.Executor()


def test_engine_from_a_loaded_bundle_and_its_public_surface(bundle):
    """The constructor's loaded-bundle form (program=, feed_names=,
    fetch_vars=, executor=, scope=) serves as the model_dir form does;
    feed_names/fetch_names copy, warmed and hot_recompiles count as the
    reference's engine counts them, and release() drops the parameters."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    program, feeds, fetches = tfluid.io.load_inference_model(
        bundle, exe, scope=scope)
    eng = InferenceEngine(program=program, feed_names=feeds,
                          fetch_vars=fetches, executor=exe, scope=scope,
                          buckets=BUCKETS)
    ref = InferenceEngine(bundle, place=tfluid.CPUPlace(), buckets=BUCKETS)
    x = _images(3, seed=7)
    assert np.array_equal(eng.infer({"img": x})[0], ref.infer({"img": x})[0])
    assert eng.feed_names == ["img"] and len(eng.fetch_names) == 1
    eng.feed_names.append("junk")                  # a copy
    assert eng.feed_names == ["img"]
    assert not eng.warmed and eng.hot_recompiles == 0
    assert eng.warmup() == 2          # buckets 1 and 2 first dispatched now
    assert eng.warmed and eng.warmup() == 0
    eng.infer({"img": x}, fetch_list=eng.fetch_names[::-1])
    assert eng.hot_recompiles == 0    # the same (bucket, fetch, feed) seen
    eng.infer({"img": x.astype("float64")})        # cast to float32 first
    assert eng.hot_recompiles == 0
    eng.infer({"img": _images(3)[:, :16]})         # another feed shape
    assert eng.hot_recompiles == 1
    st = eng.stats()
    assert st["compiles"] == 4 and st["hot_recompiles"] == 1
    assert st["memory"]["param_bytes"] > 0
    assert st["memory"]["source"] == "process_rss"
    eng.release()
    assert not eng.warmed and eng.stats()["memory"]["param_bytes"] == 0
    with pytest.raises(ValueError, match="model_dir= or all of"):
        InferenceEngine(program=program, place=tfluid.CPUPlace())
