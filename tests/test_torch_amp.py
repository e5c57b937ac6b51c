"""AMP (bfloat16 compute, float32 master weights) in the port, against the
reference's AMP on the same numpy inputs.

* The port's counterparts of both cases of tests/test_amp.py.
* Single ops under AMP in both packages (the reference's eager executor,
  so that each of its jnp ops rounds as written): ``mul``/``mul_grad``,
  ``conv2d``/``conv2d_grad``, ``fused_conv2d_bn``/``_grad`` on the plain
  chain of both packages and on the kernel route (the reference's Pallas
  kernels in interpret mode, the port's kernel wrappers' plain versions),
  ``batch_norm``/``batch_norm_grad`` on bfloat16 and float32 activations.
  Each output's dtype must be the reference's.
* A conv+bn+fc program trained 3 steps under AMP in both packages (the
  reference's jit executor, as a user runs it).
* Which dtype reaches ``lstm`` and ``gru`` under AMP in each package, and
  which route each takes.
* The executor's feed rule: a tensor already on the executor's device
  keeps its dtype; host arrays are cast to the declared dtype.
* Under AMP every parameter and optimizer state stays float32, and the
  arena optimizers still take one call a step.
* The AMP state is per thread: an AMP executor and a float32 one run at
  the same time in two threads, each in its own dtypes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.flags import set_flags as jset_flags
from paddle_tpu.ops import rnn_ops as jrnn_ops
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core import amp as tamp
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops import rnn_ops as trnn_ops
from paddle_tpu_torch.ops.cuda import conv_bn as cbk
from paddle_tpu_torch.ops.cuda import optimizer as topk

# One bfloat16 step is 2^-8 of a value. An op that sums exact bf16 x bf16
# products in float32 and rounds once (mul, the convs) differs from the
# other package's only by a summation order, which moves the float32 sum
# far less than a step, so its rounding lands at most one step apart: an
# output within ONE_STEP of the largest output.
ONE_STEP = 2.0 ** -8
# A chain of roundings (the fused conv+bn: z rounded, then y; the grad: z,
# dz, then the GEMMs on them) can move by a step at each rounding and carry
# it on, so a few steps: 4 steps of the largest.
FEW_STEPS = 4 * ONE_STEP
# The reference's jit executor keeps float32 between fused ops where the
# program rounds to bfloat16 (XLA's excess precision: the BN statistics of
# a conv read the conv's unrounded float32 sums), and its average pool
# sums a bf16 window in bf16, so a whole program under jit differs from
# the port by a step here and there in every layer, carried through 3
# momentum steps: measured 1.111e-2 of the largest on the worst step-1
# gradient and 7.145e-3 on the worst final state; 3e-2.
PROGRAM_REL = 3e-2


@pytest.fixture(autouse=True)
def _fresh():
    from paddle_tpu_torch.fluid import framework
    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    framework.reset_unique_name()
    tfluid.set_flags({"kernel_tier": "auto"})
    yield
    tfluid.set_flags({"kernel_tier": "auto"})
    jset_flags({"kernel_tier": "auto"})


def _np(v):
    """A fetched value (either package) as float64 numpy, and its dtype
    name."""
    if isinstance(v, torch.Tensor):
        return v.detach().double().cpu().numpy(), str(v.dtype).split(".")[1]
    a = np.asarray(v)
    return a.astype(np.float64), str(a.dtype)


def _rel(got, want):
    """max|got − want| / max|want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _compare(got, want, limit, names):
    """Each name's dtype the reference's and max|Δ| within ``limit`` of the
    largest; prints the worst (seen with ``-s``) and returns it."""
    worst = (0.0, None)
    for name in names:
        g, gd = _np(got[name])
        w, wd = _np(want[name])
        assert gd == wd, f"{name}: dtype {gd}, the reference's {wd}"
        assert g.shape == w.shape, name
        rel = _rel(g, w)
        assert rel <= limit, f"{name}: {rel:.3e} of the largest > {limit}"
        if worst[1] is None or rel > worst[0]:
            worst = (rel, name)
    print(f"worst of {len(names)}: {worst[1]} {worst[0]:.3e} of the "
          f"largest (limit {limit:.3e})")
    return worst


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).normal(0, 1, shape)
            * scale).astype("float32")


# ---------------------------------------------------------------------------
# core/amp.py
# ---------------------------------------------------------------------------

def test_cast_compute_and_upcast_follow_the_state():
    f32 = torch.ones(2)
    f64 = torch.ones(2, dtype=torch.float64)
    i64 = torch.ones(2, dtype=torch.int64)
    assert tamp.cast_compute(f32) is f32
    assert not tamp.amp_enabled()
    with tfluid.amp_guard():
        assert tamp.amp_enabled() and tamp.amp_dtype() == torch.bfloat16
        a, b, c = tamp.cast_compute(f32, f64, i64)
        assert (a.dtype, b.dtype, c.dtype) == (torch.bfloat16,
                                               torch.bfloat16, torch.int64)
        assert tamp.cast_compute(a) is a
        assert tamp.upcast_f32(a).dtype == torch.float32
        assert tamp.upcast_f32(f64) is f64
        with tfluid.amp_guard(False):
            assert tamp.cast_compute(f32) is f32
        assert tamp.amp_enabled()
    assert not tamp.amp_enabled()


def test_bf16_gemms_accumulate_in_float32():
    """Importing the port turns cuBLAS's bf16 reduced-precision reduction
    off once; AMP does not switch it per run."""
    mm = torch.backends.cuda.matmul
    assert mm.allow_bf16_reduced_precision_reduction is False
    with tfluid.amp_guard():
        assert mm.allow_bf16_reduced_precision_reduction is False
    assert mm.allow_bf16_reduced_precision_reduction is False


def test_amp_state_is_per_thread(monkeypatch):
    """An AMP executor and a float32 one run the same program at the same
    time in two threads. The ``mul`` op waits until both threads are inside
    their op loops, so a process-wide state would be the last thread's for
    both; each thread's GEMM must still come out in its own executor's
    dtype, on every run."""
    import dataclasses
    import threading
    from paddle_tpu_torch.core import registry
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[16])
        h = tfluid.layers.fc(x, 32, bias_attr=False)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    feed = {"x": _rand(8, 16, seed=3)}
    both_inside = threading.Barrier(2, timeout=60)
    info = registry.get_op_info("mul")

    def mul(ctx):
        both_inside.wait()
        info.forward(ctx)

    monkeypatch.setitem(registry._REGISTRY, "mul",
                        dataclasses.replace(info, forward=mul))
    dtypes = {True: [], False: []}
    errors = []

    def work(amp):
        try:
            exe = tfluid.Executor(tfluid.CPUPlace(), amp=amp)
            for _ in range(5):
                out, = exe.run(main, feed=feed, fetch_list=[h], scope=scope,
                               return_numpy=False)
                dtypes[amp].append(out.dtype)
        except Exception as e:  # surfaced below
            both_inside.abort()
            errors.append(e)

    threads = [threading.Thread(target=work, args=(a,))
               for a in (True, False)]
    with tfluid.amp_guard():  # the caller's context reaches neither
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert tamp.amp_enabled()
    assert not errors, errors
    assert dtypes == {True: [torch.bfloat16] * 5, False: [torch.float32] * 5}
    assert not tamp.amp_enabled()


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_amp.py
# ---------------------------------------------------------------------------

def _amp_build(fluid, conv):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if conv:
            img = fluid.layers.data("x", shape=[8, 8, 3])
            c = fluid.layers.conv2d(img, 8, 3, padding=1, act=None,
                                    bias_attr=False, data_format="NHWC")
            b = fluid.layers.batch_norm(c, act="relu", data_layout="NHWC")
            feat = fluid.layers.pool2d(b, global_pooling=True,
                                       data_format="NHWC")
        else:
            feat = fluid.layers.data("x", shape=[16])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=feat, size=32, act="relu")
        logits = fluid.layers.fc(input=h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss, startup)
    return main, startup, loss


def _amp_feeds(conv, rng):
    x = rng.normal(0, 1, (16, 8, 8, 3) if conv else (16, 16))
    return {"x": x.astype("float32"),
            "label": rng.randint(0, 4, (16, 1)).astype("int64")}


def test_amp_converges_and_keeps_fp32_master_weights():
    main, startup, loss = _amp_build(tfluid, conv=True)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace(), amp=True)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses = [float(exe.run(main, feed=_amp_feeds(True, rng),
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(30)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9
    for v in main.global_block().vars.values():
        if v.persistable and scope.has_var(v.name):
            assert scope.find_var(v.name).dtype == torch.float32, v.name


def test_amp_matches_fp32_closely_at_start():
    """One step of AMP and of float32 training from the same start: the
    updated parameters agree to bf16-level tolerance (the reference's own,
    tests/test_amp.py:76-77)."""
    feed = _amp_feeds(False, np.random.RandomState(1))
    results = {}
    for amp in (False, True):
        tfluid.reset_unique_name()
        main, startup, loss = _amp_build(tfluid, conv=False)
        main.random_seed = startup.random_seed = 7
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace(), amp=amp)
        exe.run(startup, scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        p = main.global_block().all_parameters()[0]
        results[amp] = scope.find_var(p.name).numpy()
    np.testing.assert_allclose(results[False], results[True], rtol=0.05,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# single ops under AMP, both packages
# ---------------------------------------------------------------------------

def _run_ops(fluid, ops, feeds, fetch, declared=None):
    """Run ``ops`` ([(type, {slot: [names]}, {slot: [names]}, attrs)]) in
    one program under AMP, on the reference's eager executor or the port's,
    and fetch ``fetch``. ``declared`` maps a fed name to its declared
    dtype (float32 otherwise)."""
    prog = fluid.Program()
    block = prog.global_block()
    declared = declared or {}
    for name, arr in feeds.items():
        block.create_var(name=name, shape=arr.shape,
                         dtype=declared.get(name, str(arr.dtype)))
    for _, _, outs, _ in ops:
        for names in outs.values():
            for n in names:
                if not block.has_var(n):
                    block.create_var(name=n)
    for op_type, ins, outs, attrs in ops:
        block.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)
    if fluid is jfluid:
        exe = fluid.Executor(fluid.CPUPlace(), mode="eager", amp=True)
    else:
        exe = fluid.Executor(fluid.CPUPlace(), amp=True)
    vals = exe.run(prog, feed=dict(feeds), fetch_list=list(fetch),
                   scope=fluid.Scope(), return_numpy=False)
    return dict(zip(fetch, vals))


def _both(ops, feeds, fetch, declared=None):
    return (_run_ops(tfluid, ops, feeds, fetch, declared),
            _run_ops(jfluid, ops, feeds, fetch, declared))


def test_mul_and_mul_grad_compute_in_bf16():
    x, y = _rand(6, 2, 5, seed=1), _rand(10, 7, seed=2)
    dout = _rand(6, 7, seed=3)
    ops = [("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]},
            {"x_num_col_dims": 1, "y_num_col_dims": 1}),
           ("mul_grad", {"X": ["x"], "Y": ["y"], "Out@GRAD": ["dout"]},
            {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]},
            {"x_num_col_dims": 1, "y_num_col_dims": 1})]
    got, want = _both(ops, {"x": x, "y": y, "dout": dout},
                      ["out", "dx", "dy"])
    _compare(got, want, ONE_STEP, ["out", "dx", "dy"])
    assert all(got[n].dtype == torch.bfloat16 for n in ("out", "dx", "dy"))
    # and the product is the bf16 operands' exact products summed in
    # float32, rounded once
    xb = torch.from_numpy(x).reshape(6, 10).bfloat16().double()
    yb = torch.from_numpy(y).bfloat16().double()
    exact = (xb @ yb).numpy()
    assert _rel(_np(got["out"])[0], exact) <= ONE_STEP


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (7, 2, 3), (1, 2, 0)])
def test_conv2d_and_grad_compute_in_bf16(k, stride, pad):
    x = _rand(2, 9, 9, 4, seed=4)
    w = _rand(6, 4, k, k, seed=5, scale=(2.0 / (4 * k * k)) ** 0.5)
    ho = (9 + 2 * pad - k) // stride + 1
    dout = _rand(2, ho, ho, 6, seed=6)
    attrs = {"strides": [stride] * 2, "paddings": [pad] * 2,
             "dilations": [1, 1], "groups": 1, "data_format": "NHWC"}
    ops = [("conv2d", {"Input": ["x"], "Filter": ["w"]},
            {"Output": ["out"]}, attrs),
           ("conv2d_grad", {"Input": ["x"], "Filter": ["w"],
                            "Output@GRAD": ["dout"]},
            {"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"]}, attrs)]
    got, want = _both(ops, {"x": x, "w": w, "dout": dout},
                      ["out", "dx", "dw"])
    _compare(got, want, ONE_STEP, ["out", "dx", "dw"])
    # Input@GRAD in the compute dtype, Filter@GRAD the float32 master
    # gradient (reference conv_ops.py:205-210)
    assert got["dx"].dtype == torch.bfloat16
    assert got["dw"].dtype == torch.float32


def _fused_ops(act, is_test, stride, pad):
    attrs = {"strides": [stride] * 2, "paddings": [pad] * 2,
             "dilations": [1, 1], "groups": 1, "data_format": "NHWC",
             "epsilon": 1e-5, "momentum": 0.9, "act": act,
             "is_test": is_test}
    fwd = ("fused_conv2d_bn",
           {"Input": ["x"], "Filter": ["w"], "Scale": ["scale"],
            "Bias": ["bias"], "Mean": ["rm"], "Variance": ["rv"]},
           {"Output": ["y"], "MeanOut": ["rm_out"],
            "VarianceOut": ["rv_out"], "SavedMean": ["sm"],
            "SavedVariance": ["sv"]}, attrs)
    bwd = ("fused_conv2d_bn_grad",
           {"Input": ["x"], "Filter": ["w"], "Scale": ["scale"],
            "Bias": ["bias"], "SavedMean": ["sm"], "SavedVariance": ["sv"],
            "Output": ["y"], "Output@GRAD": ["dy"]},
           {"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"],
            "Scale@GRAD": ["dscale"], "Bias@GRAD": ["dbias"]}, attrs)
    return [fwd] if is_test else [fwd, bwd]


def _fused_feeds(k, stride, pad, seed=0):
    cin, cout = 8, 12
    ho = (8 + 2 * pad - k) // stride + 1
    return {"x": _rand(2, 8, 8, cin, seed=seed),
            "w": _rand(cout, cin, k, k, seed=seed + 1,
                       scale=(2.0 / (cin * k * k)) ** 0.5),
            "scale": np.random.RandomState(seed + 2).uniform(
                0.5, 1.5, cout).astype("float32"),
            "bias": _rand(cout, seed=seed + 3, scale=0.1),
            "rm": _rand(cout, seed=seed + 4, scale=0.1),
            "rv": np.random.RandomState(seed + 5).uniform(
                0.5, 1.5, cout).astype("float32"),
            "dy": _rand(2, ho, ho, cout, seed=seed + 6)}


FUSED_OUTS = ["y", "rm_out", "rv_out", "sm", "sv"]
FUSED_GRADS = ["dx", "dw", "dscale", "dbias"]


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (1, 2, 0)])
def test_fused_conv2d_bn_computes_in_bf16(k, stride, pad, act, is_test,
                                           route, monkeypatch):
    """Both routes of both packages: the plain chains (reference
    kernel_tier=jnp, port torch), and the kernel route (the reference's
    Pallas kernels in interpret mode; the port's wrappers, whose plain
    versions run on the CPU, called with bf16 x)."""
    jset_flags({"kernel_tier": "jnp" if route == "plain" else "pallas"})
    tfluid.set_flags({"kernel_tier": "torch" if route == "plain"
                      else "cuda"})
    seen = []
    for name in ("conv_affine", "conv_bn_train", "conv_bn_bwd"):
        real = getattr(cbk, name)

        def spy(x, *args, _real=real, _name=name):
            seen.append((_name, x.dtype))
            return _real(x, *args)
        monkeypatch.setattr(cbk, name, spy)
    ttier.reset_fallback_counts()
    fetch = FUSED_OUTS + ([] if is_test else FUSED_GRADS)
    got, want = _both(_fused_ops(act, is_test, stride, pad),
                      _fused_feeds(k, stride, pad), fetch)
    _compare(got, want, FEW_STEPS, fetch)
    assert got["y"].dtype == torch.bfloat16
    assert all(got[n].dtype == torch.float32 for n in FUSED_OUTS[1:])
    if not is_test:
        assert got["dx"].dtype == torch.bfloat16
        # the kernel's dw is float32 (reference pallas/conv_bn.py:433), the
        # plain chain's the cast filter's bf16 (the reference's jnp vjp)
        assert got["dw"].dtype == (torch.float32 if route == "kernel"
                                   else torch.bfloat16)
    if route == "kernel":
        want_calls = [("conv_affine",)] if is_test else \
            [("conv_bn_train",), ("conv_bn_bwd",)]
        assert [s[:1] for s in seen] == want_calls
        assert all(dt == torch.bfloat16 for _, dt in seen)
        assert ttier.fallback_counts() == {}
    else:
        assert seen == []


@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("name", ["conv_affine", "conv_bn_train",
                                  "conv_bn_bwd"])
def test_wrappers_take_a_float32_or_bf16_filter_alike(name, act):
    """The fused op hands the wrappers the float32 master filter; its bf16
    cast gives bitwise the same results: the kernels round the filter to x's
    dtype as the cast does (both to nearest even)."""
    f = _fused_feeds(3, 1, 1, seed=9)
    x = torch.from_numpy(f["x"]).bfloat16()
    w32 = torch.from_numpy(f["w"])
    sc, bi = torch.from_numpy(f["scale"]), torch.from_numpy(f["bias"])
    args = ((1, 1), (1, 1), act)
    if name == "conv_affine":
        def run(w):
            return (cbk.conv_affine(x, w, sc, bi, *args),)
    elif name == "conv_bn_train":
        def run(w):
            return cbk.conv_bn_train(x, w, sc, bi, 1e-5, *args)
    else:
        _, mean, var = cbk.conv_bn_train(x, w32, sc, bi, 1e-5, *args)
        dy = torch.from_numpy(f["dy"]).bfloat16()

        def run(w):
            return cbk.conv_bn_bwd(x, w, dy, sc, bi, mean, var, 1e-5, *args)
    for a, b in zip(run(w32), run(w32.bfloat16())):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_batch_norm_statistics_under_amp(x_dtype):
    """batch_norm and its grad on bf16 (AMP's) or float32 activations, the
    statistics in float32 (the single-pass E[x²]−E[x]² for bf16, the
    centered two-pass variance for float32)."""
    c = 6
    x = _rand(4, 5, 5, c, seed=11) * 2 + 0.5
    feeds = {"x": x, "scale": _rand(c, seed=12) + 1.0,
             "bias": _rand(c, seed=13, scale=0.1),
             "rm": np.zeros(c, "float32"), "rv": np.ones(c, "float32"),
             "dy": _rand(4, 5, 5, c, seed=14)}
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NHWC",
             "is_test": False}
    ops = [("batch_norm",
            {"X": ["x"], "Scale": ["scale"], "Bias": ["bias"],
             "Mean": ["rm"], "Variance": ["rv"]},
            {"Y": ["y"], "MeanOut": ["rm_out"], "VarianceOut": ["rv_out"],
             "SavedMean": ["sm"], "SavedVariance": ["sv"]}, attrs),
           ("batch_norm_grad",
            {"X": ["x"], "Scale": ["scale"], "SavedMean": ["sm"],
             "SavedVariance": ["sv"], "Y@GRAD": ["dy"]},
            {"X@GRAD": ["dx"], "Scale@GRAD": ["dscale"],
             "Bias@GRAD": ["dbias"]}, attrs)]
    stats = ["rm_out", "rv_out", "sm", "sv"]
    rest = ["y", "dx", "dscale", "dbias"]
    declared = {"x": x_dtype, "dy": x_dtype}
    got, want = _both(ops, feeds, stats + rest, declared)
    assert str(got["y"].dtype) == f"torch.{x_dtype}"
    assert got["sm"].dtype == got["sv"].dtype == torch.float32
    _compare(got, want, FEW_STEPS, stats + rest)


# ---------------------------------------------------------------------------
# a conv+bn+fc program trained under AMP in both packages
# ---------------------------------------------------------------------------

def _program(fluid, fuse, pool_type):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    L = fluid.layers
    with fluid.program_guard(main, startup):
        img = L.data("img", shape=[8, 8, 3])
        label = L.data("label", shape=[1], dtype="int64")
        h = L.batch_norm(L.conv2d(img, 8, 3, padding=1, bias_attr=False,
                                  data_format="NHWC"),
                         act="relu", data_layout="NHWC")
        h = L.batch_norm(L.conv2d(h, 8, 1, stride=2, bias_attr=False,
                                  data_format="NHWC"),
                         data_layout="NHWC")
        h = L.pool2d(h, pool_type=pool_type, global_pooling=True,
                     data_format="NHWC")
        h = L.fc(h, 16)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), label))
        if fuse:
            assert fluid.fuse_conv_bn(main) == 2
        fluid.optimizer.Momentum(0.1, 0.9, fused=fuse).minimize(
            loss, startup)
    return main, startup, loss


def _program_feed():
    rng = np.random.RandomState(2)
    return {"img": rng.normal(0, 1, (8, 8, 8, 3)).astype("float32"),
            "label": rng.randint(0, 4, (8, 1)).astype("int64")}


@pytest.mark.parametrize("fuse,route", [(False, "plain"), (True, "plain"),
                                        (True, "kernel")])
def test_program_trains_under_amp_like_the_reference(fuse, route):
    """3 steps of a conv+bn+fc program under AMP: the losses, step 1's
    gradients (each in the reference's dtype) and the final state within
    PROGRAM_REL of the largest. Global average pooling and no relu after
    the hidden fc: a global max pool sends each channel's whole gradient
    to one position, and a relu's mask drops a unit's, which two packages
    that round a step apart may pick differently where values lie within
    a step (see test_max_pool_picks_within_a_rounding)."""
    jset_flags({"kernel_tier": "jnp" if route == "plain" else "pallas"})
    tfluid.set_flags({"kernel_tier": "torch" if route == "plain"
                      else "cuda"})
    jmain, jstart, jloss = _program(jfluid, fuse, "avg")
    jexe = jfluid.Executor(jfluid.CPUPlace(), amp=True)
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    state = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and not v.is_data]
    init = {n: np.array(jscope.find_var(n)) for n in state}
    grads = [p.name + "@GRAD" for p in jmain.global_block().all_parameters()
             if p.trainable]
    tmain, _, tloss = _program(tfluid, fuse, "avg")
    tscope = tfluid.io.scope_from_numpy(init, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace(), amp=True)
    feed = _program_feed()
    for step in range(3):
        want = jexe.run(jmain, feed=feed, fetch_list=[jloss] + grads,
                        scope=jscope, return_numpy=False)
        got = texe.run(tmain, feed=feed, fetch_list=[tloss] + grads,
                       scope=tscope, return_numpy=False)
        names = ["loss"] + grads
        _compare(dict(zip(names, got)), dict(zip(names, want)),
                 PROGRAM_REL, names if step == 0 else ["loss"])
    final_t = {n: tscope.find_var(n) for n in state}
    final_j = {n: jscope.find_var(n) for n in state}
    _compare(final_t, final_j, PROGRAM_REL, state)
    assert all(v.dtype == torch.float32 for v in final_t.values())


def test_max_pool_picks_within_a_rounding():
    """tests/test_amp.py's conv model ends in a global max pool, which
    sends each channel's whole gradient to one position. Its packages
    round the BN output a step apart (the reference's jit keeps the conv's
    float32 sums for the statistics), so their gradients of the pool's
    input go to other positions in some windows, and only in windows whose
    two largest values in the port's forward lie within two bf16 steps."""
    jset_flags({"kernel_tier": "jnp"})
    tfluid.set_flags({"kernel_tier": "torch"})
    feed = _amp_feeds(True, np.random.RandomState(0))
    jfluid.framework.reset_unique_name()
    jmain, jstart, jloss = _amp_build(jfluid, conv=True)
    jmain.random_seed = jstart.random_seed = 7
    jexe = jfluid.Executor(jfluid.CPUPlace(), amp=True)
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jmain.global_block().vars.values()
            if v.persistable and not v.is_data}
    pool_in = [op for op in jmain.global_block().ops
               if op.type == "pool2d"][0].input("X")[0]
    filt = jmain.global_block().all_parameters()[0].name + "@GRAD"
    fetch = [jloss, pool_in, pool_in + "@GRAD", filt]
    want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope,
                    return_numpy=False)
    tmain, _, tloss = _amp_build(tfluid, conv=True)
    got = tfluid.Executor(tfluid.CPUPlace(), amp=True).run(
        tmain, feed=feed, fetch_list=[tloss] + fetch[1:],
        scope=tfluid.io.scope_from_numpy(init, "cpu"), return_numpy=False)
    assert _rel(_np(got[0])[0], _np(want[0])[0]) <= PROGRAM_REL
    act = _np(got[1])[0]                                # [n, h, w, c]
    n, c = act.shape[0], act.shape[3]
    top2 = np.sort(act.reshape(n, -1, c), axis=1)[:, -2:, :]
    near = (top2[:, 1] - top2[:, 0]) <= 2 * ONE_STEP * np.abs(top2[:, 1])
    picked_t = (_np(got[2])[0] != 0).reshape(n, -1, c)
    picked_j = (_np(want[2])[0] != 0).reshape(n, -1, c)
    moved = (picked_t != picked_j).any(axis=1)          # [n, c] windows
    print(f"{int(moved.sum())} of {moved.size} windows moved; {filt} "
          f"{_rel(_np(got[3])[0], _np(want[3])[0]):.3e} of its largest "
          "from the reference's")
    assert moved.any(), "the packages picked the same maxima throughout"
    assert not (moved & ~near).any()


# ---------------------------------------------------------------------------
# lstm / gru: the dtype that reaches them under AMP
# ---------------------------------------------------------------------------

def _rnn_program(fluid, cell, fc_bias, rnn_bias, train=True):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    L = fluid.layers
    hidden = 16
    with fluid.program_guard(main, startup):
        words = L.data("words", shape=[1], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        net = L.embedding(words, size=(50, 8))
        width = hidden * (4 if cell == "lstm" else 3)
        proj = L.fc(net, width, bias_attr=None if fc_bias else False)
        battr = None if rnn_bias else False
        if cell == "lstm":
            net, _ = L.dynamic_lstm(proj, size=width, bias_attr=battr)
        else:
            net = L.dynamic_gru(proj, size=hidden, bias_attr=battr)
        prob = L.fc(L.sequence_last_step(net), 2, act="softmax")
        loss = L.mean(L.cross_entropy(prob, label))
        if train:
            fluid.optimizer.Adam(2e-3, fused=True).minimize(loss, startup)
    return main, startup, loss


def _rnn_feed(fluid):
    rng = np.random.RandomState(4)
    seqs = [rng.randint(0, 50, (n, 1)).astype("int64") for n in (5, 3, 7, 2)]
    return {"words": fluid.pack_sequences(seqs),
            "label": rng.randint(0, 2, (4, 1)).astype("int64")}


def _spy_dtypes(monkeypatch, module, name, log, arg=0):
    """Log the dtype of argument ``arg`` (a tensor or a dtype; None: the
    ``dtype`` keyword of a recurrent cell's key) of each call."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        if arg is None:
            if "cell" in kwargs:
                log.append(kwargs["dtype"])
        else:
            v = args[arg]
            log.append(str(getattr(v, "dtype", v)).replace("torch.", ""))
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("fc_bias,rnn_bias", [(True, True), (True, False),
                                              (False, False)])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_float32_reaches_the_recurrent_kernels_under_amp(
        cell, fc_bias, rnn_bias, monkeypatch):
    """Under AMP the input projection's GEMM rounds to bf16: with the fc's
    bias the op's Input is float32 (bf16 plus a float32 bias), without it
    bf16. But both packages' dynamic_lstm/dynamic_gru always give the op a
    float32 Bias (``bias_attr=False`` freezes it; it does not drop it), and
    the op adds it before its route is picked: float32 reaches the route in
    both packages, in every case, and the port's kernel route serves it
    with no fallback. The reference's forward agrees with the port's; its
    training step does not run: its rnn grad's jax.vjp refuses the bf16
    Hidden@GRAD that the next fc's mul_grad hands it, while the port casts
    a cotangent to its output's dtype (ops/common.py::vjp)."""
    from paddle_tpu.ops import autotune as jautotune
    from paddle_tpu_torch.ops.cuda import rnn as trnn
    jset_flags({"kernel_tier": "jnp"})
    tfluid.set_flags({"kernel_tier": "cuda"})
    compute = f"_{cell}_compute"
    op_in = {"ref": [], "port": []}
    route = {"ref": [], "port": []}
    _spy_dtypes(monkeypatch, jrnn_ops, compute, op_in["ref"])
    _spy_dtypes(monkeypatch, trnn_ops, compute, op_in["port"])
    _spy_dtypes(monkeypatch, jautotune, "make_key", route["ref"], arg=None)
    _spy_dtypes(monkeypatch, trnn, "supported", route["port"], arg=2)
    want_in = "float32" if fc_bias else "bfloat16"

    # the forward, in both packages
    jmain, jstart, jloss = _rnn_program(jfluid, cell, fc_bias, rnn_bias,
                                        train=False)
    jexe = jfluid.Executor(jfluid.CPUPlace(), amp=True)
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jmain.global_block().vars.values()
            if v.persistable and not v.is_data}
    want = jexe.run(jmain, feed=_rnn_feed(jfluid), fetch_list=[jloss],
                    scope=jscope)[0]
    tmain, _, tloss = _rnn_program(tfluid, cell, fc_bias, rnn_bias,
                                   train=False)
    texe = tfluid.Executor(tfluid.CPUPlace(), amp=True)
    ttier.reset_fallback_counts()
    got = texe.run(tmain, feed=_rnn_feed(tfluid), fetch_list=[tloss],
                   scope=tfluid.io.scope_from_numpy(init, "cpu"))[0]
    assert abs(float(got) - float(want)) <= PROGRAM_REL * abs(float(want))
    assert op_in["ref"] and set(op_in["ref"]) == {want_in}
    assert op_in["port"] == [want_in]
    assert route["ref"] and set(route["ref"]) == {"float32"}
    assert route["port"] == ["float32"]
    assert ttier.fallback_counts() == {}

    # training: the port runs the kernel route's wrappers with float32 and
    # keeps every state float32; the reference raises in its rnn grad
    tmain, tstart, tloss = _rnn_program(tfluid, cell, fc_bias, rnn_bias)
    scope = tfluid.Scope()
    texe.run(tstart, scope=scope)
    losses = [float(texe.run(tmain, feed=_rnn_feed(tfluid),
                             fetch_list=[tloss], scope=scope)[0])
              for _ in range(5)]
    assert losses[-1] < losses[0]
    assert ttier.fallback_counts() == {}
    assert set(route["port"]) == {"float32"}
    for v in tmain.global_block().vars.values():
        if v.persistable and scope.has_var(v.name) \
                and torch.is_tensor(scope.find_var(v.name)) \
                and scope.find_var(v.name).is_floating_point():
            assert scope.find_var(v.name).dtype == torch.float32, v.name
    jmain, jstart, jloss = _rnn_program(jfluid, cell, fc_bias, rnn_bias)
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    with pytest.raises(ValueError, match="bfloat16"):
        jexe.run(jmain, feed=_rnn_feed(jfluid), fetch_list=[jloss],
                 scope=jscope)


def test_bf16_reaches_the_lstm_op_only_without_a_bias():
    """An lstm op with no Bias fed a bf16 input (no layer builds one): the
    reference's scan refuses the bf16 carries (its Pallas kernel runs them),
    and the port's kernels take float32 only, so the shape is a counted
    fallback to the plain chain, which refuses the bf16 x float32 product."""
    import jax
    rng = np.random.RandomState(6)
    x = rng.normal(0, 1, (2, 3, 64)).astype("float32")
    w = rng.normal(0, 0.1, (16, 64)).astype("float32")
    lens = np.array([3, 2], "int32")
    jset_flags({"kernel_tier": "jnp"})
    with pytest.raises(TypeError, match="carry"):
        jrnn_ops._lstm_compute(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(lens), jnp.asarray(w), None,
                               None, None, {})
    jset_flags({"kernel_tier": "pallas"})
    hs, _ = jrnn_ops._lstm_compute(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(lens), jnp.asarray(w), None,
                                   None, None, {})
    jax.block_until_ready(hs)
    assert hs.dtype == jnp.bfloat16
    tfluid.set_flags({"kernel_tier": "cuda"})
    ttier.reset_fallback_counts()
    with pytest.raises(RuntimeError, match="dtype"):
        trnn_ops._lstm_compute(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(lens), torch.from_numpy(w),
                               None, None, None, {})
    assert ttier.fallback_counts() == {"lstm": 1}


# ---------------------------------------------------------------------------
# the executor's feeds, the master weights and the arenas under AMP
# ---------------------------------------------------------------------------

def _feed_program(fluid):
    prog = fluid.Program()
    prog.global_block().create_var(name="img", shape=(2, 3),
                                   dtype="float32")
    return prog.global_block()


def test_a_device_resident_feed_keeps_its_dtype():
    """A dense tensor on the executor's device passes through as it is
    (reference executor.py:871-875); numpy is cast to the declared dtype
    (:910-914)."""
    block = _feed_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    staged = torch.ones((2, 3), dtype=torch.bfloat16)
    out = exe._prepare_feed(block, {"img": staged})["img"]
    assert out is staged
    out = exe._prepare_feed(
        block, {"img": np.ones((2, 3), np.float64)})["img"]
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    # a LoD feed's data is cast whatever it is
    lod = tfluid.pack_sequences([np.ones((2, 3), np.float64)])
    assert exe._prepare_feed(block, {"img": lod})["img"].data.dtype \
        == torch.float32


def test_a_host_tensor_feed_is_cast_like_a_host_array():
    """For an executor on another device (the card; ``meta`` stands in for
    it here), a CPU tensor is a host array: cast to the declared dtype and
    moved, as the reference casts its host arrays."""
    block = _feed_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.device = torch.device("meta")
    out = exe._prepare_feed(
        block, {"img": torch.ones((2, 3), dtype=torch.bfloat16)})["img"]
    assert out.dtype == torch.float32 and out.device.type == "meta"
    staged = torch.ones((2, 3), dtype=torch.bfloat16, device="meta")
    assert exe._prepare_feed(block, {"img": staged})["img"] is staged


def test_a_bf16_feed_runs_the_program_in_bf16():
    """The ResNet flagship's feed (bench.py:3420-3430): bf16 images staged
    on the device into an ``img`` declared float32 reach the first conv in
    bf16, and under AMP the step matches the float32 feed's within one
    rounding of the images."""
    tfluid.set_flags({"kernel_tier": "torch"})
    main, startup, loss = _program(tfluid, True, "avg")
    init = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace(), amp=True)
    exe.run(startup, scope=init)
    feed = _program_feed()
    names = [v for v in init.local_names()
             if torch.is_tensor(init.find_var(v))]
    out = {}
    for kind in ("numpy", "bf16"):
        scope = tfluid.Scope()
        for n in names:
            scope.set(n, init.find_var(n).clone())
        fd = dict(feed)
        if kind == "bf16":
            fd["img"] = torch.from_numpy(feed["img"]).bfloat16()
        first = main.global_block().ops[0]
        out[kind] = exe.run(main, feed=fd, fetch_list=[
            loss, first.input("Input")[0]], scope=scope,
            return_numpy=False)
    assert out["bf16"][1].dtype == torch.bfloat16
    assert out["numpy"][1].dtype == torch.float32
    # AMP casts the float32 images at the first conv: the same bf16 values
    assert float(out["bf16"][0]) == float(out["numpy"][0])


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_master_weights_and_one_arena_call_a_step(opt, monkeypatch):
    """Under AMP with the kernel route every parameter, velocity, moment
    and running statistic stays float32 in the scope, and the fused
    optimizer makes one arena call a step."""
    tfluid.set_flags({"kernel_tier": "cuda"})
    name = {"momentum": "momentum_arena", "adam": "adam_arena"}[opt]
    calls = []
    real = getattr(topk, name)

    def counted(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(topk, name, counted)
    main, startup = tfluid.Program(), tfluid.Program()
    L = tfluid.layers
    with tfluid.program_guard(main, startup):
        img = L.data("img", shape=[8, 8, 3])
        label = L.data("label", shape=[1], dtype="int64")
        h = L.batch_norm(L.conv2d(img, 8, 3, padding=1, bias_attr=False,
                                  data_format="NHWC"),
                         act="relu", data_layout="NHWC")
        h = L.pool2d(h, pool_type="avg", global_pooling=True,
                     data_format="NHWC")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), label))
        tfluid.fuse_conv_bn(main)
        if opt == "momentum":
            tfluid.optimizer.Momentum(0.1, 0.9, fused=True).minimize(
                loss, startup)
        else:
            tfluid.optimizer.Adam(0.01, fused=True).minimize(loss, startup)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace(), amp=True)
    exe.run(startup, scope=scope)
    feed = _program_feed()
    for step in range(3):
        del calls[:]
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert len(calls) == 1, step
    floats = [v.name for v in main.global_block().vars.values()
              if v.persistable and scope.has_var(v.name)
              and scope.find_var(v.name).is_floating_point()]
    assert len(floats) > len(main.global_block().all_parameters())
    for n in floats:
        assert scope.find_var(n).dtype == torch.float32, n


def test_test_clone_reaches_conv_affine_in_bf16(monkeypatch):
    """``clone(for_test=True)`` flips the fused ops' is_test, so the test
    clone of a fused program runs conv_affine, in bf16 under AMP."""
    tfluid.set_flags({"kernel_tier": "cuda"})
    main, startup, loss = _program(tfluid, True, "avg")
    test = main.clone(for_test=True)
    fused = [op for op in test.global_block().ops
             if op.type == "fused_conv2d_bn"]
    assert len(fused) == 2 and all(op.attr("is_test") for op in fused)
    seen = []
    real = cbk.conv_affine

    def spy(x, *args):
        seen.append(x.dtype)
        return real(x, *args)
    monkeypatch.setattr(cbk, "conv_affine", spy)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace(), amp=True)
    exe.run(startup, scope=scope)
    out = exe.run(test, feed=_program_feed(), fetch_list=[loss],
                  scope=scope)[0]
    assert np.isfinite(out)
    assert seen == [torch.bfloat16, torch.bfloat16]
