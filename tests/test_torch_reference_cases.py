"""The port's counterparts of the cases of tests/test_fused_conv_bn.py,
test_fused_optimizer.py, test_backward.py and test_kernel_tier.py that no
other test_torch_* file holds (the rest are held by
test_torch_conv_bn_train.py, test_torch_adam.py, test_torch_sparse.py,
test_torch_word2vec.py, test_torch_training.py, test_torch_lstm.py,
test_torch_flags.py and the OpTest harness files). The reference's
kernel_tier names map to the port's: "pallas" is the kernel route
("cuda"; its wrappers run their plain versions on CPU tensors) and "jnp"
the plain chain ("torch"). The fused-program trainings also hold each
port route's losses against the reference's plain chain from the same
startup state."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops import cuda as tier

from torch_cross import build_both, port_scope, ref_state

# the port's losses against the reference's, from one startup state
CROSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    yield
    fluid.set_flags({"kernel_tier": "auto", "use_pallas_rnn": False,
                     "use_pallas_ctc": False})
    tier.reset_fallback_counts()


# ---------------------------------------------------------------------------
# tests/test_fused_conv_bn.py
# ---------------------------------------------------------------------------

def _build_net(fuse, filter_size=3, stride=1, act="relu", lr=0.05,
               fl=fluid):
    """The reference test's network in ``fl``'s package (the port's by
    default, the reference's for the cross runs)."""
    fl.framework.reset_unique_name()
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 3
    with fl.program_guard(main, startup):
        img = fl.layers.data("img", shape=[8, 8, 3])
        label = fl.layers.data("label", shape=[1], dtype="int64")
        pad = (filter_size - 1) // 2
        c1 = fl.layers.conv2d(img, 6, filter_size, stride=stride,
                              padding=pad, bias_attr=False,
                              data_format="NHWC")
        b1 = fl.layers.batch_norm(c1, act=act, data_layout="NHWC")
        c2 = fl.layers.conv2d(b1, 8, 1, bias_attr=False,
                              data_format="NHWC")
        b2 = fl.layers.batch_norm(c2, act=None, data_layout="NHWC")
        pool = fl.layers.pool2d(b2, pool_type="avg", global_pooling=True,
                                data_format="NHWC")
        logits = fl.layers.fc(pool, size=4)
        loss = fl.layers.mean(
            fl.layers.softmax_with_cross_entropy(logits, label))
        if fuse:
            n = fl.fuse_conv_bn(main)
            assert n == 2, f"expected 2 fused chains, got {n}"
        fl.optimizer.SGD(learning_rate=lr).minimize(loss, startup)
    return main, startup, loss


def _train(fuse, route, steps=4, **build_kw):
    """The port's losses under ``route`` and the reference's losses on
    its plain chain ("jnp"), both from the reference's startup state on
    one feed: (port, reference)."""
    progs = build_both(lambda fl: _build_net(fuse, fl=fl, **build_kw))
    rng = np.random.RandomState(0)
    feed = {"img": rng.normal(0, 1, (4, 8, 8, 3)).astype("float32"),
            "label": rng.randint(0, 4, (4, 1)).astype("int64")}
    jmain, jstartup, jloss = progs["ref"]
    tmain, _, tloss = progs["port"]
    jfluid.set_flags({"kernel_tier": "jnp"})
    try:
        jexe, jscope, state = ref_state(jmain, jstartup)
        want = [float(np.asarray(jexe.run(jmain, feed=feed,
                                          fetch_list=[jloss],
                                          scope=jscope)[0]))
                for _ in range(steps)]
    finally:
        jfluid.set_flags({"kernel_tier": "auto"})
    fluid.set_flags({"kernel_tier": route})
    exe, scope = fluid.Executor(fluid.CPUPlace()), port_scope(state)
    got = [float(exe.run(tmain, feed=feed, fetch_list=[tloss],
                         scope=scope)[0]) for _ in range(steps)]
    return got, want


def test_fuse_pass_structure():
    main, _, _ = _build_net(True)
    types = [op.type for op in main.global_block().ops]
    assert types.count("fused_conv2d_bn") == 2
    assert "conv2d" not in types[:types.index("fused_conv2d_bn") + 2]
    assert "batch_norm" not in types
    assert types.count("fused_conv2d_bn_grad") == 2
    fused = [op for op in main.global_block().ops
             if op.type == "fused_conv2d_bn"]
    assert fused[0].attrs["act"] == "relu"
    assert fused[1].attrs["act"] == ""


def _check_routes(base, kern):
    """The kernel route against the plain chain at the reference test's
    tolerance, and each against the reference's losses."""
    np.testing.assert_allclose(kern[0], base[0], rtol=2e-4, atol=1e-5)
    for got, want in (base, kern):
        np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)


def test_fused_program_stride2_and_no_act():
    base = _train(False, "torch", filter_size=1, stride=2, act=None)
    kern = _train(True, "cuda", filter_size=1, stride=2, act=None)
    _check_routes(base, kern)
    assert tier.fallback_counts() == {}


def test_stride2_stays_fused_under_space_to_depth_flag():
    """conv_space_to_depth and the fused kernels are disjoint (s2d needs
    k > 1 at stride 2; conv_bn takes stride 2 only at k = 1): the flag
    must not knock the 1x1/s2 chains off the kernel route."""
    fluid.set_flags({"conv_space_to_depth": True})
    jfluid.set_flags({"conv_space_to_depth": True})
    try:
        base = _train(False, "torch", filter_size=1, stride=2, act=None)
        tier.reset_fallback_counts()
        kern = _train(True, "cuda", filter_size=1, stride=2, act=None)
    finally:
        fluid.set_flags({"conv_space_to_depth": False})
        jfluid.set_flags({"conv_space_to_depth": False})
    _check_routes(base, kern)
    assert tier.fallback_counts() == {}


def test_unsupported_shape_falls_back_silently():
    """A 5x5 filter has no fused kernel: the chain runs the plain twin and
    bumps the conv_bn fallback counter; the 1x1 chain takes the kernel
    route."""
    base = _train(False, "torch", filter_size=5)
    tier.reset_fallback_counts()
    kern = _train(True, "cuda", filter_size=5)
    _check_routes(base, kern)
    assert tier.fallback_counts().get("conv_bn", 0) > 0


# ---------------------------------------------------------------------------
# tests/test_fused_optimizer.py
# ---------------------------------------------------------------------------

def _regression(opt):
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        pred = fluid.layers.fc(fluid.layers.fc(x, size=8), size=1)
        label = fluid.layers.data("y", shape=[1])
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(pred, label)))
        opt().minimize(loss, startup)
    return [op.type for op in main.global_block().ops], main


def test_fused_program_structure():
    types, main = _regression(
        lambda: fluid.optimizer.Adam(learning_rate=0.01, fused=True))
    assert types.count("fused_adam") == 1
    assert "adam" not in types
    fused, = [op for op in main.global_block().ops
              if op.type == "fused_adam"]
    assert len(fused.input("Params")) == 4          # 2x (weight + bias)
    # one shared beta-power pair instead of a pair per parameter
    assert len(fused.input("Beta1Pow")) == 1
    assert types.count("scale") == 2


def test_unfused_optimizer_has_no_fused_op():
    """fused=False (the default) keeps the per-parameter program (the
    DistributeTranspiler's contract)."""
    types, _ = _regression(lambda: fluid.optimizer.SGD(learning_rate=0.1))
    assert "fused_sgd" not in types and types.count("sgd") == 4


def test_fused_unsupported_optimizer_raises():
    with pytest.raises(NotImplementedError, match="fused"):
        _regression(lambda: fluid.optimizer.Adagrad(learning_rate=0.1,
                                                    fused=True))


# ---------------------------------------------------------------------------
# tests/test_backward.py
# ---------------------------------------------------------------------------

@register_op("_nograd_passthrough_port")
def _nograd_passthrough(ctx):  # pragma: no cover - never run
    ctx.set_output("Out", ctx.input("X"))


def test_missing_grad_maker_off_param_path_ok():
    """An op without a grad maker whose inputs depend on no parameter
    (feed preprocessing) does not stop append_backward."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        pre = x.block.create_var(name="pre", shape=x.shape, dtype=x.dtype)
        x.block.append_op("_nograd_passthrough_port",
                          inputs={"X": [x.name]},
                          outputs={"Out": [pre.name]})
        h = fluid.layers.fc(input=pre, size=4)
        loss = fluid.layers.mean(h)
        pairs = fluid.backward.append_backward(loss)
        assert len(pairs) == 2  # the fc's weight and bias still train


# ---------------------------------------------------------------------------
# tests/test_kernel_tier.py
# ---------------------------------------------------------------------------

CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)


def test_auto_resolves_torch_on_cpu_tensors():
    fluid.set_flags({"kernel_tier": "auto"})
    assert tier.resolve_tier(CPU) == "torch"
    assert tier.resolve_tier(CUDA) == "cuda"
    assert not tier.use_kernel("lstm", True, CPU)
    assert not tier.use_kernel("conv_bn", True, CPU)


def test_explicit_tiers():
    fluid.set_flags({"kernel_tier": "cuda"})
    assert tier.resolve_tier(CPU) == "cuda"
    assert tier.use_kernel("gru", True, CPU)     # every supported shape
    fluid.set_flags({"kernel_tier": "torch"})
    assert tier.resolve_tier(CUDA) == "torch"
    assert not tier.use_kernel("lstm", True, CUDA)


def test_invalid_tier_raises():
    """The reference's tier names are not the port's."""
    for bad in ("pallas", "jnp"):
        fluid.set_flags({"kernel_tier": bad})
        with pytest.raises(ValueError, match="kernel_tier"):
            tier.resolve_tier(CPU)
        with pytest.raises(ValueError, match="kernel_tier"):
            tier.use_kernel("lstm", True, CPU)


def test_unsupported_shape_falls_back_with_counter_bump():
    fluid.set_flags({"kernel_tier": "cuda"})
    tier.reset_fallback_counts()
    assert not tier.use_kernel("conv_bn", False, CPU)
    assert not tier.use_kernel("conv_bn", False, CPU)
    assert not tier.use_kernel("optimizer", False, CPU)
    assert tier.fallback_counts() == {"conv_bn": 2, "optimizer": 1}
    assert tier.use_kernel("conv_bn", True, CPU)
    assert tier.fallback_counts()["conv_bn"] == 2
    # under the torch tier nothing wants the kernel: nothing is a fallback
    fluid.set_flags({"kernel_tier": "torch"})
    tier.reset_fallback_counts()
    assert not tier.use_kernel("conv_bn", False, CPU)
    assert tier.fallback_counts() == {}


def test_registry_manifest_and_engine_stats_carry_kernel_tier(tmp_path):
    from paddle_tpu_torch.serving import InferenceEngine, ModelRegistry

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        y = fluid.layers.fc(input=x, size=3, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "model")
    fluid.io.save_inference_model(d, ["x"], [y], exe, main, scope=scope)

    reg = ModelRegistry(str(tmp_path / "registry"))
    v = reg.publish("m", d, place=fluid.CPUPlace())
    assert reg.manifest("m", v)["kernel_tier"] == tier.resolve_tier(CPU)
    v2 = reg.publish("m", d, kernel_tier="cuda", place=fluid.CPUPlace())
    assert reg.manifest("m", v2)["kernel_tier"] == "cuda"
    with pytest.raises(ValueError, match="kernel_tier"):
        reg.publish("m", d, kernel_tier="pallas", place=fluid.CPUPlace())
    # the failed publish leaves no torn version dir behind
    assert reg.publish("m", d, place=fluid.CPUPlace()) == v2 + 1
    reg.verify("m", v2)

    eng = InferenceEngine(d, place=fluid.CPUPlace(), buckets="1,2")
    assert eng.stats()["kernel_tier"] == tier.resolve_tier(CPU)
    fluid.set_flags({"kernel_tier": "cuda"})
    eng.warmup()
    st = eng.stats()
    assert st["kernel_tier"] == "cuda" and st["warmed"]
