"""The reference's last core flags on the port (paddle_tpu_torch/core/
flags.py), each read where the reference reads it and held against the
reference on the CPU:

* ``conv_space_to_depth``: the stem rewrite against the direct conv and
  against the reference's rewrite, a training slice with the flag on and
  off, the filter kept OIHW, and a ResNet-50 step's kernel-wrapper calls
  and fallbacks the same both ways;
* ``conv_1x1_grad_as_dot``: conv2d_grad's channel-product branch against
  the reference's, and a training run with the flag on and off;
* ``bn_fusion_barrier*``: the identity here, so every output bitwise;
* ``use_pallas_rnn`` / ``use_pallas_ctc``: the deprecated flags win over
  ``kernel_tier`` on CUDA tensors and warn once;
* ``xla_compiler_options``: loads, and every path that runs a block (the
  Executor, the sharded step, the exported program) refuses a value.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu.ops.conv_ops import (_conv2d_compute as ref_conv,
                                     _s2d_stem_conv as ref_s2d)
from paddle_tpu_torch.core.flags import get_flag, set_flags
from paddle_tpu_torch.ops import conv_ops
from paddle_tpu_torch.ops import cuda as tier
from paddle_tpu_torch.ops.cuda import conv_bn as cbk
from paddle_tpu_torch.ops.cuda import optimizer as opk
from paddle_tpu_torch.testing import models as M

from torch_cross import (build_both, cross_losses, op_both, port_scope,
                         ref_state)

NEW_FLAGS = {"conv_space_to_depth": False, "conv_1x1_grad_as_dot": False,
             "bn_fusion_barrier": False, "bn_fusion_barrier_fwd": False,
             "bn_fusion_barrier_bwd": False, "use_pallas_rnn": False,
             "use_pallas_ctc": False, "xla_compiler_options": ""}


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    set_flags(dict(NEW_FLAGS, kernel_tier="auto"))
    jfluid.set_flags({k: v for k, v in NEW_FLAGS.items()})
    tier.reset_fallback_counts()


def test_the_port_defines_every_reference_flag_but_bn_bf16_stats():
    from paddle_tpu.core.flags import flags as ref_flags
    from paddle_tpu_torch.core.flags import flags as port_flags
    ref, port = ref_flags(), port_flags()
    assert set(ref) - set(port) == {"bn_bf16_stats"}
    assert set(port) <= set(ref) and len(port) == 61
    for name, value in port.items():
        assert value == ref[name] and type(value) is type(ref[name]), name


# ---------------------------------------------------------------------------
# conv_space_to_depth
# ---------------------------------------------------------------------------

S2D_CASES = [
    ((64, 64), 3, 16, 7, 3),   # the ResNet stem's geometry, scaled down
    ((32, 32), 3, 8, 5, 2),
    ((16, 20), 4, 8, 3, 1),
    ((32, 32), 1, 8, 7, 3),
    ((8, 12), 3, 4, 4, 1),     # an even filter: the odd grid offset
]


@pytest.mark.parametrize("hw,c,o,k,p", S2D_CASES)
def test_s2d_matches_direct_conv_and_the_reference(hw, c, o, k, p):
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, hw[0], hw[1], c)).astype("float32")
    w = rng.normal(size=(o, c, k, k)).astype("float32")
    direct = conv_ops.conv2d_compute(torch.tensor(x), torch.tensor(w),
                                     (2, 2), (p, p), (1, 1), 1, "NHWC")
    y = conv_ops._s2d_stem_conv(torch.tensor(x), torch.tensor(w), (p, p))
    assert y.shape == direct.shape
    np.testing.assert_allclose(y.numpy(), direct.numpy(), rtol=1e-5,
                               atol=1e-4)
    want = np.asarray(ref_s2d(x, w, (p, p)))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        direct.numpy(), np.asarray(ref_conv(x, w, (2, 2), (p, p), (1, 1), 1,
                                            "NHWC")), rtol=1e-5, atol=1e-4)


def test_s2d_eligibility_is_the_references():
    """Stride 2, ungrouped, undilated, NHWC, C_in <= 4, k > 1, even H and
    W; the flag reads it per conv."""
    x = torch.zeros((1, 8, 8, 3))
    w = torch.zeros((4, 3, 3, 3))
    ok = conv_ops._s2d_stem_eligible
    assert ok(x, w, (2, 2), (1, 1), (1, 1), 1, "NHWC")
    assert not ok(x, w, (1, 1), (1, 1), (1, 1), 1, "NHWC")
    assert not ok(x, w, (2, 2), (1, 1), (2, 2), 1, "NHWC")
    assert not ok(x, w, (2, 2), (1, 1), (1, 1), 1, "NCHW")
    assert not ok(torch.zeros((1, 8, 8, 5)), torch.zeros((4, 5, 3, 3)),
                  (2, 2), (1, 1), (1, 1), 1, "NHWC")
    assert not ok(torch.zeros((1, 9, 8, 3)), w, (2, 2), (1, 1), (1, 1), 1,
                  "NHWC")
    assert not ok(x, torch.zeros((4, 3, 1, 1)), (2, 2), (0, 0), (1, 1), 1,
                  "NHWC")
    assert not conv_ops._use_s2d(x, w, (2, 2), (1, 1), (1, 1), 1, "NHWC")
    set_flags({"conv_space_to_depth": True})
    assert conv_ops._use_s2d(x, w, (2, 2), (1, 1), (1, 1), 1, "NHWC")
    # a padding past the filter still rewrites exactly
    for p in (3, 4):
        np.testing.assert_allclose(
            conv_ops._s2d_stem_conv(x + 1, w + 1, (p, p)).numpy(),
            np.asarray(ref_s2d(x.numpy() + 1, w.numpy() + 1, (p, p))),
            rtol=1e-5)


def _stem_slice(f):
    """The reference test's conv+BN+pool slice (tests/test_conv_s2d.py)."""
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup):
        img = f.layers.data("img", shape=[32, 32, 3])
        label = f.layers.data("label", shape=[1], dtype="int64")
        conv = f.layers.conv2d(img, num_filters=8, filter_size=7, stride=2,
                               padding=3, act=None, bias_attr=False,
                               data_format="NHWC")
        bn = f.layers.batch_norm(conv, act="relu", data_layout="NHWC")
        pool = f.layers.pool2d(bn, pool_size=4, pool_type="avg",
                               global_pooling=True, data_format="NHWC")
        logits = f.layers.fc(pool, size=4)
        loss = f.layers.mean(f.layers.softmax_with_cross_entropy(logits,
                                                                 label))
        f.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
    return main, startup, loss


def test_s2d_flag_end_to_end_grad():
    """The slice trained with the flag on and off (both packages) lands on
    the same losses at rtol 1e-4 / atol 1e-5, the reference test's
    tolerance; the stored filter stays OIHW 7x7."""
    rng = np.random.RandomState(1)
    feed = {"img": rng.normal(size=(4, 32, 32, 3)).astype("float32"),
            "label": rng.randint(0, 4, (4, 1)).astype("int64")}
    got = {}
    for flag in (False, True):
        set_flags({"conv_space_to_depth": flag})
        jfluid.set_flags({"conv_space_to_depth": flag})
        progs = build_both(_stem_slice)
        got[flag], want = cross_losses(progs, feed, steps=2, rtol=1e-4)
        filt = [p for p in progs["port"][0].global_block().all_parameters()
                if p.name.startswith("conv2d")]
        assert [tuple(p.shape) for p in filt] == [(8, 3, 7, 7)]
    np.testing.assert_allclose(got[True], got[False], rtol=1e-4, atol=1e-5)


def test_s2d_filter_grad_through_the_rewrite_matches_the_reference():
    """conv2d_grad with the flag on: the vjp through the rewritten
    forward, held against the reference's (its vjp of _conv2d_compute)."""
    rng = np.random.RandomState(2)
    x = rng.normal(size=(2, 16, 16, 3)).astype("float32")
    w = rng.normal(size=(4, 3, 7, 7)).astype("float32")
    dy = rng.normal(size=(2, 8, 8, 4)).astype("float32")
    attrs = {"strides": [2, 2], "paddings": [3, 3], "dilations": [1, 1],
             "groups": 1, "data_format": "NHWC"}
    for flag in (False, True):
        set_flags({"conv_space_to_depth": flag})
        jfluid.set_flags({"conv_space_to_depth": flag})
        op_both("conv2d_grad", {"Input": ["x"], "Filter": ["w"],
                                "Output@GRAD": ["dy"]},
                {"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"]}, attrs,
                {"x": x, "w": w, "dy": dy})


def _count_wrappers(monkeypatch):
    """Count the conv_bn_train / conv_bn_bwd / momentum_arena wrapper calls
    (their plain versions run on the CPU, where wrappers count no
    launch)."""
    calls = {"conv_bn_train": 0, "conv_bn_bwd": 0, "momentum_arena": 0}
    for mod, name in ((cbk, "conv_bn_train"), (cbk, "conv_bn_bwd"),
                      (opk, "momentum_arena")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _resnet50_step(flag, init_state=None):
    set_flags({"conv_space_to_depth": flag, "kernel_tier": "cuda"})
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[64, 64, 3])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = M.resnet(img, 10)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            logits, label))
        assert fluid.fuse_conv_bn(main) == 53
        fluid.optimizer.Momentum(0.01, 0.9, fused=True).minimize(loss,
                                                                 startup)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"img": rng.normal(0, 1, (2, 64, 64, 3)).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    tier.reset_fallback_counts()
    loss_v, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return float(loss_v), tier.fallback_counts()


def test_s2d_leaves_a_resnet50_steps_routes_alone(monkeypatch):
    """Stride 2 with k > 1 is outside conv_bn.supported(), so the stem
    takes the plain chain either way: a ResNet-50 step (64x64 images,
    batch 2, kernel_tier=cuda) makes the same wrapper calls and counts
    the same fallbacks with the flag on and off, and its loss agrees (at
    32x32 the last stage's batch norm sees 2 values a channel, and its
    loss moves with any rounding)."""
    calls = _count_wrappers(monkeypatch)
    seen = {}
    for flag in (False, True):
        for k in calls:
            calls[k] = 0
        loss, fallbacks = _resnet50_step(flag)
        seen[flag] = (dict(calls), fallbacks, loss)
    assert seen[True][:2] == seen[False][:2]
    assert seen[False][0] == {"conv_bn_train": 49, "conv_bn_bwd": 49,
                              "momentum_arena": 1}
    assert seen[False][1] == {"conv_bn": 8}
    np.testing.assert_allclose(seen[True][2], seen[False][2], rtol=1e-4)


# ---------------------------------------------------------------------------
# conv_1x1_grad_as_dot
# ---------------------------------------------------------------------------

def _train_1x1(f, flag):
    """The reference test's 1x1-conv classifier, trained 4 SGD steps."""
    f.set_flags({"conv_1x1_grad_as_dot": flag})
    f.framework.reset_unique_name()
    main, startup = f.Program(), f.Program()
    main.random_seed = startup.random_seed = 7
    with f.program_guard(main, startup):
        img = f.layers.data("img", shape=[8, 8, 4])
        label = f.layers.data("label", shape=[1], dtype="int64")
        conv = f.layers.conv2d(img, num_filters=8, filter_size=1,
                               act="relu", bias_attr=False,
                               data_format="NHWC")
        pool = f.layers.pool2d(conv, pool_size=8, pool_type="avg",
                               global_pooling=True, data_format="NHWC")
        logits = f.layers.fc(pool, size=3)
        loss = f.layers.mean(f.layers.softmax_with_cross_entropy(logits,
                                                                 label))
        f.optimizer.SGD(0.1).minimize(loss, startup)
    return main, startup, loss


def test_conv_1x1_grad_as_dot_parity(monkeypatch):
    """Losses with the flag on equal those with it off at the reference
    test's rtol 1e-5 / atol 1e-6, and the reference's on-flag run's; the
    branch engages (the conv backward is never called)."""
    rng = np.random.RandomState(0)
    feed = {"img": rng.normal(0, 1, (4, 8, 8, 4)).astype("float32"),
            "label": rng.randint(0, 3, (4, 1)).astype("int64")}
    runs = {}
    for flag in (False, True):
        jfluid.set_flags({"conv_1x1_grad_as_dot": flag})
        progs = {"ref": _train_1x1(jfluid, flag),
                 "port": _train_1x1(fluid, flag)}
        if flag:
            def no_backward(*a, **k):
                raise AssertionError("the 1x1 branch did not engage")
            monkeypatch.setattr(conv_ops, "conv2d_backward", no_backward)
        runs[flag], _ = cross_losses(progs, feed, steps=4, rtol=1e-5)
    np.testing.assert_allclose(runs[True], runs[False], rtol=1e-5,
                               atol=1e-6)
    assert runs[False][-1] < runs[False][0]


@pytest.mark.parametrize("amp", [False, True])
def test_conv_1x1_grad_as_dot_dtypes(amp):
    """dx in the compute dtype, dw in float32, both the conv backward's
    within the products' rounding; off the branch's conditions the op
    takes the conv backward."""
    from paddle_tpu_torch.core.amp import amp_guard
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.normal(size=(2, 5, 5, 6)).astype("float32"))
    w = torch.tensor(rng.normal(size=(4, 6, 1, 1)).astype("float32"))
    dy = torch.tensor(rng.normal(size=(2, 5, 5, 4)).astype("float32"))
    with amp_guard(amp):
        dx, dw = conv_ops._grad_1x1_as_dot(x, w, dy)
        rx, rw = conv_ops.conv2d_backward(x, w, dy, (1, 1), (0, 0), (1, 1),
                                          1, "NHWC")
    assert dx.dtype == (torch.bfloat16 if amp else torch.float32)
    assert dw.dtype == torch.float32 and dw.shape == w.shape
    tol = dict(rtol=2e-2, atol=5e-2) if amp else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.float().numpy(), rx.float().numpy(), **tol)
    np.testing.assert_allclose(dw.numpy(), rw.float().numpy(), **tol)


# ---------------------------------------------------------------------------
# the batch-norm fusion barriers
# ---------------------------------------------------------------------------

BARRIERS = ("bn_fusion_barrier", "bn_fusion_barrier_fwd",
            "bn_fusion_barrier_bwd")


def _bn_net(fl, fuse):
    """A conv + batch_norm(relu) net in ``fl``'s package, fused or not."""
    fl.framework.reset_unique_name()
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 3
    with fl.program_guard(main, startup):
        img = fl.layers.data("img", shape=[8, 8, 3])
        label = fl.layers.data("label", shape=[1], dtype="int64")
        c1 = fl.layers.conv2d(img, 6, 3, padding=1, bias_attr=False,
                              data_format="NHWC")
        b1 = fl.layers.batch_norm(c1, act="relu", data_layout="NHWC")
        pool = fl.layers.pool2d(b1, pool_type="avg", global_pooling=True,
                                data_format="NHWC")
        logits = fl.layers.fc(pool, size=4)
        loss = fl.layers.mean(
            fl.layers.softmax_with_cross_entropy(logits, label))
        if fuse:
            assert fl.fuse_conv_bn(main) == 1
        fl.optimizer.SGD(learning_rate=0.05).minimize(loss, startup)
    return main, startup, loss


def _bn_feed():
    rng = np.random.RandomState(0)
    return {"img": rng.normal(0, 1, (4, 8, 8, 3)).astype("float32"),
            "label": rng.randint(0, 4, (4, 1)).astype("int64")}


def _bn_net_losses(fuse, flags, state=None):
    """The port's 3 losses and final parameters, from ``state`` (the
    reference's startup, numpy by name) or from the port's startup."""
    set_flags(dict(dict.fromkeys(BARRIERS, False), **flags))
    main, startup, loss = _bn_net(fluid, fuse)
    exe = fluid.Executor(fluid.CPUPlace())
    if state is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
    else:
        scope = port_scope(state)
    feed = _bn_feed()
    out = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
           for _ in range(3)]
    params = {p.name: scope.find_var(p.name).numpy()
              for p in main.global_block().all_parameters()}
    return out, params


def _ref_bn_losses(fuse, flags):
    """The reference's 3 losses on its plain chain with ``flags`` set, and
    its startup state."""
    jfluid.set_flags(dict(dict.fromkeys(BARRIERS, False), kernel_tier="jnp",
                          **flags))
    try:
        jmain, jstartup, jloss = _bn_net(jfluid, fuse)
        jexe, jscope, state = ref_state(jmain, jstartup)
        feed = _bn_feed()
        out = [float(np.asarray(jexe.run(jmain, feed=feed,
                                         fetch_list=[jloss],
                                         scope=jscope)[0]))
               for _ in range(3)]
    finally:
        jfluid.set_flags(dict(dict.fromkeys(BARRIERS, False),
                              kernel_tier="auto"))
    return out, state


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("flag", BARRIERS)
def test_fusion_barriers_are_bitwise_the_identity(fuse, flag):
    """Each barrier flag leaves the port's step bitwise as it was, and the
    port's losses with it on are the reference's with it on, from the
    reference's startup state."""
    ref_l, state = _ref_bn_losses(fuse, {flag: True})
    base_l, base_p = _bn_net_losses(fuse, {}, state)
    got_l, got_p = _bn_net_losses(fuse, {flag: True}, state)
    assert [float(v) for v in got_l] == [float(v) for v in base_l]
    for name in base_p:
        np.testing.assert_array_equal(got_p[name], base_p[name],
                                      err_msg=name)
    np.testing.assert_allclose([float(v) for v in got_l], ref_l, rtol=1e-5)


def test_barrier_flags_are_read_where_the_reference_reads_them(monkeypatch):
    """batch_norm reads the forward OR, batch_norm_grad the backward OR."""
    from paddle_tpu_torch.ops import norm_ops
    seen = []
    real = norm_ops.optimization_barrier

    def spy(x):
        seen.append(tuple(x.shape))
        return real(x)
    monkeypatch.setattr(norm_ops, "optimization_barrier", spy)
    for flags, want in (({}, 0), ({"bn_fusion_barrier_fwd": True}, 1),
                        ({"bn_fusion_barrier_bwd": True}, 2),
                        ({"bn_fusion_barrier": True}, 3)):
        seen.clear()
        _bn_net_losses(False, flags)
        # per step: one barrier in the forward, two (x, dy) in the grad
        assert len(seen) == 3 * want, (flags, len(seen))


# ---------------------------------------------------------------------------
# the deprecated kernel flags
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")


@pytest.mark.parametrize("flag,kernels", [("use_pallas_rnn",
                                           ("lstm", "gru")),
                                          ("use_pallas_ctc", ("ctc",))])
def test_legacy_flag_forces_the_kernel_route_and_warns_once(flag, kernels):
    """The reference's test_legacy_flag_forces_pallas_with_deprecation_
    warning: under kernel_tier=torch a true legacy flag wins for CUDA
    tensors (a device object: nothing runs), warns once for the flag, and
    moves no CPU work; other families keep the tier's route."""
    tier._warned_legacy.clear()
    set_flags({"kernel_tier": "torch", flag: True})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for k in kernels:
            assert tier.use_kernel(k, True, CUDA)
            assert tier.use_kernel(k, True, CUDA)
            assert not tier.use_kernel(k, True, CPU)
        assert not tier.use_kernel("conv_bn", True, CUDA)
    deps = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(deps) == 1 and flag in str(deps[0].message)
    # an unsupported shape still routes to the plain chain, counted
    tier.reset_fallback_counts()
    assert not tier.use_kernel(kernels[0], False, CUDA)
    assert tier.fallback_counts() == {kernels[0]: 1}
    set_flags({flag: False})
    assert not tier.use_kernel(kernels[0], True, CUDA)


def test_legacy_flags_leave_cpu_programs_on_their_route(monkeypatch):
    """A CPU LSTM classifier step under kernel_tier=torch with
    use_pallas_rnn on runs the plain scan (no kernel wrapper is called)
    and is bitwise the step with it off."""
    from paddle_tpu_torch.ops.cuda import rnn as rnnk

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel wrapper")
    monkeypatch.setattr(rnnk.LstmSeq, "apply", refuse)

    def step(flag):
        set_flags({"kernel_tier": "torch", "use_pallas_rnn": flag})
        fluid.reset_unique_name()
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1
        with fluid.program_guard(main, startup):
            words = fluid.layers.data("words", shape=[1], dtype="int64",
                                      lod_level=1)
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            prob = M.lstm_textcls(words, vocab=30, emb=8, hidden=16,
                                  lstm_num=1)
            loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
            fluid.optimizer.Adam(2e-3).minimize(loss, startup)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        seqs = [rng.randint(0, 30, (n, 1)).astype("int64") for n in (3, 5)]
        feed = {"words": fluid.pack_sequences(seqs),
                "label": np.array([[0], [1]], "int64")}
        return [float(exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope)[0]) for _ in range(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert step(True) == step(False)


# ---------------------------------------------------------------------------
# xla_compiler_options
# ---------------------------------------------------------------------------

def test_xla_compiler_options_loads_and_is_refused_when_set():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3])
        y = fluid.layers.fc(x, 2)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 3), "float32")}
    exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    rest = fluid.init_flags(
        ["--xla_compiler_options=xla_tpu_scoped_vmem_limit_kib=114688",
         "prog"])
    assert rest == ["prog"]
    assert get_flag("xla_compiler_options")
    with pytest.raises(ValueError, match="xla_compiler_options"):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    with pytest.raises(ValueError, match="xla_compiler_options"):
        exe.run_steps(main, [feed], fetch_list=[y], scope=scope)
    set_flags({"xla_compiler_options": ""})
    exe.run(main, feed=feed, fetch_list=[y], scope=scope)


def test_xla_compiler_options_refused_by_every_compiled_path(tmp_path):
    """The reference forwards the flag on every compiled path, the sharded
    step included (paddle_tpu/parallel/sharding.py): the port's sharded
    step refuses it when built, and the exported program when run."""
    from paddle_tpu_torch.fluid import aot
    from paddle_tpu_torch.parallel import (ShardingPlan, make_mesh,
                                           shard_program_step)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3])
        y = fluid.layers.fc(x, 2)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 3), "float32")}
    plan = ShardingPlan(make_mesh(1, axes=("dp",)))
    set_flags({"xla_compiler_options": "xla_tpu_scoped_vmem_limit_kib=1"})
    try:
        with pytest.raises(ValueError, match="xla_compiler_options"):
            shard_program_step(exe, main, feed, [y], plan, scope=scope)
        with pytest.raises(ValueError, match="xla_compiler_options"):
            aot.export_inference_artifact(str(tmp_path), ["x"], [y], exe,
                                          main_program=main, scope=scope)
    finally:
        set_flags({"xla_compiler_options": ""})


def test_executor_takes_the_references_modes():
    for mode in ("jit", "eager"):
        assert fluid.Executor(fluid.CPUPlace(), mode=mode).device.type \
            == "cpu"
    with pytest.raises(ValueError, match="mode"):
        fluid.Executor(fluid.CPUPlace(), mode="aot")
