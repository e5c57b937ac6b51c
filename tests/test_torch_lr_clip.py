"""The port's learning-rate schedules, gradient clips on sparse tables, the
new activation and elementwise kinds, multi-input fc, the sum, scale and
cast grad makers, DataFeeder and WeightedAverage against the reference.

Each test builds one program in both packages and runs it on the same
numpy inputs (the port under ``CPUPlace``, taking the reference's startup
state by name where there is one). Schedules: every step's rate within
rtol 1e-6 of the reference's, and 1e-5 of the closed form (the
reference's own tolerance, tests/test_lr_and_clip.py). Sparse tables: the
rows no id looked up bitwise unchanged, the others within 1e-5 of the
largest element.
"""

import math

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.sparse import is_sparse
from paddle_tpu_torch.ops.cuda import embedding as tembk

# float32 through a few small ops and back, summed in other orders by XLA
# and PyTorch: held to 1e-5 of each value's largest element
REL = 1e-5

SCHEDULES = {
    "exponential": (
        lambda L: L.exponential_decay(0.5, decay_steps=3, decay_rate=0.7),
        lambda s: 0.5 * 0.7 ** (s / 3.0)),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.5, decay_steps=3, decay_rate=0.7,
                                      staircase=True),
        lambda s: 0.5 * 0.7 ** (s // 3)),
    "natural_exp": (
        lambda L: L.natural_exp_decay(1.0, decay_steps=2, decay_rate=0.5),
        lambda s: math.exp(-0.5 * s / 2.0)),
    "inverse_time": (
        lambda L: L.inverse_time_decay(1.0, decay_steps=2, decay_rate=0.5),
        lambda s: 1.0 / (1 + 0.5 * s / 2.0)),
    "polynomial": (
        lambda L: L.polynomial_decay(1.0, decay_steps=4,
                                     end_learning_rate=0.1, power=2.0),
        lambda s: 0.9 * (1 - min(s, 4) / 4.0) ** 2 + 0.1),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(1.0, decay_steps=3,
                                     end_learning_rate=0.1, power=1.0,
                                     cycle=True),
        lambda s: 0.9 * (1 - s / (3 * max(1, math.ceil(s / 3.0)))) + 0.1),
    "piecewise": (
        lambda L: L.piecewise_decay(boundaries=[3, 6],
                                    values=[1.0, 0.5, 0.1]),
        lambda s: 1.0 if s < 3 else (0.5 if s < 6 else 0.1)),
    "noam": (
        lambda L: L.noam_decay(d_model=64, warmup_steps=4),
        lambda s: 64 ** -0.5 * min(s ** -0.5, s * 4 ** -1.5)),
}


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def run_schedule(fluid, build, steps=7):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        lr = build(fluid.layers)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    vals = [np.asarray(exe.run(main, fetch_list=[lr], scope=scope)[0])
            for _ in range(steps)]
    return main, vals, scope


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_reference(name):
    build, closed = SCHEDULES[name]
    jmain, want, _ = run_schedule(jfluid, build)
    tmain, got, scope = run_schedule(tfluid, build)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    for g in got:   # what the arena kernels read: float32 [1]
        assert g.dtype == np.float32 and g.shape == (1,)
    got = [float(g[0]) for g in got]
    np.testing.assert_allclose(got, [float(w.reshape(-1)[0]) for w in want],
                               rtol=1e-6)
    np.testing.assert_allclose(got, [closed(s) for s in range(1, 8)],
                               rtol=1e-5)
    counter = scope.find_var("@LR_DECAY_COUNTER@")
    assert str(counter.dtype) == "torch.int64" and counter.tolist() == [7]


def test_scheduled_momentum_trains_and_reads_the_rate():
    """Momentum driven by a schedule variable trains; the update op reads
    the schedule's output as its LearningRate."""
    tfluid.reset_unique_name()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[8])
        y = tfluid.layers.data("y", shape=[1])
        loss = tfluid.layers.mean(tfluid.layers.square(
            tfluid.layers.elementwise_sub(tfluid.layers.fc(x, 1), y)))
        lr = tfluid.layers.exponential_decay(0.1, decay_steps=5,
                                             decay_rate=0.9)
        tfluid.optimizer.Momentum(lr, 0.9, fused=True).minimize(loss,
                                                                startup)
    update, = [op for op in main.global_block().ops
               if op.type == "fused_momentum"]
    assert update.input("LearningRate") == [lr.name]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    w = rng.normal(0, 1, (8, 1)).astype("float32")
    losses = []
    for _ in range(20):
        xs = rng.normal(0, 1, (32, 8)).astype("float32")
        losses.append(float(exe.run(main, feed={"x": xs, "y": xs @ w},
                                    fetch_list=[loss], scope=scope)[0]))
    assert losses[-1] < 0.2 * losses[0]


def test_global_norm_group_conflict_raises():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        h = tfluid.layers.fc(x, size=4, param_attr=tfluid.ParamAttr(
            name="w1",
            gradient_clip=tfluid.clip.GradientClipByGlobalNorm(1.0)))
        pred = tfluid.layers.fc(h, size=1, param_attr=tfluid.ParamAttr(
            name="w2",
            gradient_clip=tfluid.clip.GradientClipByGlobalNorm(5.0)))
        loss = tfluid.layers.mean(pred)
        with pytest.raises(ValueError, match="conflicting clip_norm"):
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)


VOCAB, EMB = 10, 4
SPARSE_CLIPS = {
    "value": lambda f: f.clip.GradientClipByValue(max=0.01),
    "norm": lambda f: f.clip.GradientClipByNorm(clip_norm=0.05),
    "global": lambda f: f.clip.GradientClipByGlobalNorm(clip_norm=0.05),
    "none": lambda f: None,
}
SPARSE_FEED = {"ids": np.array([[1], [2], [1]], dtype=np.int64),
               "y": 100.0 * np.ones((3, EMB), np.float32)}
UNTOUCHED = [0, 3, 4, 5, 6, 7, 8, 9]


def build_sparse(fluid, clip, opt="sgd", decay=None):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        y = fluid.layers.data("y", shape=[EMB])
        e = fluid.layers.embedding(
            ids, size=[VOCAB, EMB], is_sparse=True,
            param_attr=fluid.ParamAttr(name="emb_w",
                                       gradient_clip=SPARSE_CLIPS[clip](fluid)))
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(e, y)))
        o = {"sgd": lambda: fluid.optimizer.SGD(1.0, fused=True),
             "adagrad": lambda: fluid.optimizer.Adagrad(0.5)}[opt]()
        o.regularization = decay and fluid.regularizer.L2Decay(decay)
        o.minimize(loss, startup)
    return main, startup, loss


def sparse_runs(clip, opt="sgd", decay=None, route="cuda", steps=2):
    """(initial table, reference tables, port tables after each step, the
    port's update op's Grad input fetched at step 1)."""
    jfluid.set_flags({"kernel_tier": "jnp"})
    main, startup, loss = build_sparse(jfluid, clip, opt, decay)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable]
    init = {n: np.array(scope.find_var(n)) for n in names}
    want = []
    for _ in range(steps):
        exe.run(main, feed=SPARSE_FEED, fetch_list=[loss], scope=scope)
        want.append(np.array(scope.find_var("emb_w")))
    tfluid.set_flags({"kernel_tier": route})
    tmain, _, tloss = build_sparse(tfluid, clip, opt, decay)
    update = [op for op in tmain.global_block().ops
              if op.type in ("fused_sgd", "adagrad")][0]
    grad = update.input("Grads" if opt == "sgd" else "Grad")[0]
    tscope = tfluid.io.scope_from_numpy(init, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    got, fetched = [], None
    for step in range(steps):
        out = texe.run(tmain, feed=SPARSE_FEED,
                       fetch_list=[tloss] + ([grad] if step == 0 else []),
                       scope=tscope)
        fetched = out[1] if step == 0 else fetched
        got.append(tscope.find_var("emb_w").numpy())
    return init["emb_w"], want, got, fetched


@pytest.mark.parametrize("route", ["torch", "cuda"])
@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_clip_on_sparse_embedding_grad(clip, route):
    """The reference test's three clips of an is_sparse table
    (tests/test_lr_and_clip.py:233) through SGD(fused=True): the clipped
    gradient stays SparseRows (merged by the value and norm clips), the
    rows no id looked up stay bitwise, and each step's table agrees with
    the reference's. The ``cuda`` route runs the embedding_sgd wrapper
    (its plain version on the CPU) on the clipped rows."""
    w0, want, got, grad = sparse_runs(clip, route=route)
    assert is_sparse(grad)
    assert grad.merged == (clip != "global")
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g[UNTOUCHED], w0[UNTOUCHED])
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= REL, (step, rel)
    moved = np.abs(got[0][[1, 2]] - w0[[1, 2]])
    assert moved.max() > 0
    if clip == "value":
        assert moved.max() <= 0.01 + 1e-6
    else:
        assert np.sqrt((moved ** 2).sum()) <= 0.05 + 1e-5


def test_clipped_sparse_table_calls_embedding_sgd(monkeypatch):
    """Under the kernel route the globally clipped table still takes
    embedding_sgd, once a step; an L2-decayed table is densified by the
    decay's sum (reference tensor_ops.py:319-330) and takes the dense
    update, as in the reference."""
    calls = []
    real = tembk.embedding_sgd
    monkeypatch.setattr(tembk, "embedding_sgd",
                        lambda *a: calls.append(1) or real(*a))
    sparse_runs("global", steps=2)
    assert len(calls) == 2
    calls.clear()
    w0, want, got, grad = sparse_runs("none", decay=0.1, steps=2)
    assert not calls and not is_sparse(grad)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() / np.abs(w).max() <= REL
    # the decay moved the rows no id looked up
    assert not np.array_equal(got[0][UNTOUCHED], w0[UNTOUCHED])


@pytest.mark.parametrize("clip", ["none", "global"])
def test_adagrad_on_sparse_table(clip):
    """Adagrad, the classic CTR optimizer, on an is_sparse table: the
    reference's lazy per-row update (apply_rowwise), untouched rows and
    their moments bitwise, the rest within REL."""
    w0, want, got, grad = sparse_runs(clip, opt="adagrad", steps=3)
    assert is_sparse(grad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[UNTOUCHED], w0[UNTOUCHED])
        assert np.abs(g - w).max() / np.abs(w).max() <= REL


def grads_of(fluid, build, feed, fetch_names, init=None):
    """Run a forward + backward program once; returns (the loss and the
    fetched values, startup state, the program). ``fetch_names`` None
    fetches every parameter's gradient."""
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup):
        loss = build(fluid)
        pairs = fluid.append_backward(loss)
    if fetch_names is None:
        fetch_names = [g.name for _, g in pairs]
    exe = fluid.Executor(fluid.CPUPlace())
    if init is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        init = {v.name: np.array(scope.find_var(v.name))
                for v in main.global_block().vars.values() if v.persistable}
    else:
        scope = fluid.io.scope_from_numpy(init, "cpu")
    vals = exe.run(main, feed=feed, fetch_list=[loss] + fetch_names,
                   scope=scope)
    return [np.asarray(v) for v in vals], init, main


def assert_same_run(build, feed, fetch_names=None):
    want, init, jmain = grads_of(jfluid, build, feed, fetch_names)
    got, _, tmain = grads_of(tfluid, build, feed, fetch_names, init)
    assert len(got) == len(want) > 1
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    for name, g, w in zip(["loss"] + list(fetch_names or range(len(got))),
                          got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=name)
        fin = ~np.isnan(w)
        scale = max(np.abs(w[fin]).max(initial=0), 1e-30)
        assert np.abs(g[fin] - w[fin]).max(initial=0) <= REL * scale, name


ACTIVATIONS = [
    ("sigmoid", {}), ("logsigmoid", {}), ("exp", {}), ("relu", {}),
    ("tanh", {}), ("tanh_shrink", {}), ("softshrink", {"lambda": 0.3}),
    ("sqrt", {}), ("abs", {}), ("ceil", {}), ("floor", {}), ("round", {}),
    ("reciprocal", {}), ("log", {}), ("square", {}), ("softplus", {}),
    ("softsign", {}), ("brelu", {"t_min": -0.5, "t_max": 0.5}),
    ("leaky_relu", {}), ("soft_relu", {}), ("elu", {"alpha": 0.5}),
    ("relu6", {"threshold": 1.0}), ("pow", {"factor": 1.7}),
    ("stanh", {}), ("hard_shrink", {}), ("thresholded_relu", {}),
    ("hard_sigmoid", {}), ("swish", {"beta": 1.5}),
]
POSITIVE = {"sqrt", "log", "pow", "reciprocal"}


@pytest.mark.parametrize("act,attrs", ACTIVATIONS,
                         ids=[a for a, _ in ACTIVATIONS])
def test_activation_forward_and_grad(act, attrs):
    rng = np.random.RandomState(len(act))
    x = rng.normal(0, 1.5, (4, 6)).astype("float32")
    if act in POSITIVE:
        x = np.abs(x) + 0.1

    def build(fluid):
        xv = fluid.layers.data("x", shape=[6], stop_gradient=False)
        out = getattr(fluid.layers, act)(xv, **attrs)
        return fluid.layers.mean(fluid.layers.elementwise_mul(out, out))

    assert_same_run(build, {"x": x}, ["x@GRAD"])


ELEMENTWISE = ["add", "sub", "mul", "div", "max", "min", "pow"]


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("kind", ELEMENTWISE)
def test_elementwise_forward_and_grad(kind, broadcast):
    """Each kind with a full-shape and a broadcast (axis 1) Y; max and min
    with ties planted."""
    rng = np.random.RandomState(ELEMENTWISE.index(kind))
    x = rng.normal(0, 1, (4, 3, 5)).astype("float32")
    y = rng.normal(0, 1, (3,) if broadcast else (3, 5)).astype("float32")
    if kind in ("div", "pow"):
        x, y = np.abs(x) + 0.5, np.abs(y) + 0.5
    if kind in ("max", "min") and not broadcast:
        x[:, 0, :2] = y[0, :2]

    def build(fluid):
        xv = fluid.layers.data("x", shape=[3, 5], stop_gradient=False)
        yv = fluid.layers.data("y", shape=list(y.shape),
                               append_batch_size=False, stop_gradient=False)
        out = getattr(fluid.layers, "elementwise_" + kind)(
            xv, yv, axis=1 if broadcast else -1)
        return fluid.layers.mean(fluid.layers.square(out))

    assert_same_run(build, {"x": x, "y": y}, ["x@GRAD", "y@GRAD"])


@pytest.mark.parametrize("kind", ["max", "min"])
def test_elementwise_max_min_propagate_nan(kind):
    """A NaN in X comes out of max and min and their grads where the
    reference's jnp.maximum/minimum and masks put it."""
    rng = np.random.RandomState(11)
    x = rng.normal(0, 1, (4, 3, 5)).astype("float32")
    y = rng.normal(0, 1, (3, 5)).astype("float32")
    x[1, 1, 1] = x[2, 0, 3] = np.nan

    def build(fluid):
        xv = fluid.layers.data("x", shape=[3, 5], stop_gradient=False)
        yv = fluid.layers.data("y", shape=[3, 5], append_batch_size=False,
                               stop_gradient=False)
        out = getattr(fluid.layers, "elementwise_" + kind)(xv, yv)
        return fluid.layers.mean(fluid.layers.elementwise_mul(out, yv))

    assert_same_run(build, {"x": x, "y": y}, ["x@GRAD", "y@GRAD"])


def test_multi_input_fc_and_its_grads():
    """fc over two inputs: a mul per input, their sum (reference
    nn.py:46), bias, activation; both weights' gradients."""
    rng = np.random.RandomState(3)
    feed = {"a": rng.normal(0, 1, (5, 4)).astype("float32"),
            "b": rng.normal(0, 1, (5, 7)).astype("float32")}

    def build(fluid):
        a = fluid.layers.data("a", shape=[4])
        b = fluid.layers.data("b", shape=[7])
        h = fluid.layers.fc([a, b], 6, act="tanh")
        return fluid.layers.mean(fluid.layers.fc(h, 2))

    assert_same_run(build, feed)


def test_sum_scale_and_cast_grad_makers():
    """A loss through sums, scale, cast and clip: the reference's grad
    ops (an assign per summed input, a scale of the output grad, a cast
    back, clip_grad's mask) and the same gradients."""
    rng = np.random.RandomState(8)
    feed = {"x": rng.normal(0, 2, (5, 4)).astype("float32")}

    def build(fluid):
        L = fluid.layers
        x = L.data("x", shape=[4])
        a, b = L.fc(x, 3), L.fc(x, 3)
        s = L.scale(L.sums([a, b]), scale=2.5, bias=0.5)
        c = L.cast(L.cast(s, "float64"), "float32")
        return L.mean(L.square(L.clip(c, -1.0, 1.0)))

    assert_same_run(build, feed)


def test_comparison_and_logical_layers():
    def run(fluid):
        fluid.framework.reset_unique_name()
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            L = fluid.layers
            x = L.data("x", shape=[3], dtype="int64")
            y = L.data("y", shape=[3], dtype="int64")
            lt, eq = L.less_than(x, y), L.equal(x, y)
            outs = [lt, eq, L.logical_and(lt, eq), L.logical_or(lt, eq),
                    L.logical_xor(lt, eq), L.logical_not(lt),
                    L.argmax(L.cast(x, "float32"), axis=1)]
        feed = {"x": np.array([[1, 2, 3], [4, 4, 0]], "int64"),
                "y": np.array([[2, 2, 2], [4, 5, 1]], "int64")}
        return fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=outs, scope=fluid.Scope())

    for g, w in zip(run(tfluid), run(jfluid)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_data_feeder_and_weighted_average():
    def feed(fluid):
        fluid.framework.reset_unique_name()
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            img = fluid.layers.data("img", shape=[2, 3])
            words = fluid.layers.data("words", shape=[1], dtype="int64",
                                      lod_level=1)
        rows = [(np.arange(6) + i, list(range(i + 1))) for i in range(3)]
        return fluid.DataFeeder([img, words]).feed(rows)

    got, want = feed(tfluid), feed(jfluid)
    np.testing.assert_array_equal(got["img"], want["img"])
    assert got["img"].shape == (3, 2, 3)
    np.testing.assert_array_equal(np.asarray(got["words"].data),
                                  np.asarray(want["words"].data))
    np.testing.assert_array_equal(np.asarray(got["words"].lens),
                                  np.asarray(want["words"].lens))
    avgs = [f.average.WeightedAverage() for f in (tfluid, jfluid)]
    for a in avgs:
        a.add(2.0, 1)
        a.add(np.array([4.0]), 3)
    assert avgs[0].eval() == avgs[1].eval() == 3.5
    with pytest.raises(ValueError):
        tfluid.average.WeightedAverage().eval()
