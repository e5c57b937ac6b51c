"""The rest of the op breadth in the port against the reference
(counterparts of tests/test_breadth_ops.py, tests/test_misc_ops.py and the
depthwise and transposed cases of tests/test_conv_ops.py): each op on
seeded inputs through both packages, then its grad op fed the forward's
outputs and a seeded cotangent (``torch_cross.fwd_grad``). Float32 within
rtol 1e-5 and 1e-6 of the largest element, integers exactly. The fluid
layers that append these ops build the reference's program op for op and
train alike (losses within 1e-5 relative over 4 SGD steps). Under AMP the
conv family computes in bfloat16 at the reference's cast sites, each
output in the reference's dtype and within one bfloat16 step of the
largest."""

import numpy as np
import pytest
import torch

from torch_cross import (assert_same_program, build_both, cross_losses,
                         f32, fwd_grad, jfluid, op_both, run_op, tfluid)

X = {"X": ["x"]}
OUT = {"Out": ["out"]}
DX = {"X@GRAD": ["dx"]}
CONV_IN = {"Input": ["x"], "Filter": ["w"]}
CONV_OUT = {"Output": ["out"]}
CONV_GRAD = {"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"]}


def _conv(attrs, x, w):
    return lambda rng: (CONV_IN, CONV_OUT, attrs,
                        {"x": f32(rng, *x), "w": f32(rng, *w)}, CONV_IN,
                        CONV_GRAD, "Output")


# case -> (op type, rng -> (ins, outs, attrs, feeds, grad ins, grad outs,
# cotangent slot))
CASES = {
    "expand": ("expand", lambda rng: (
        X, OUT, {"expand_times": [2, 1, 3]}, {"x": f32(rng, 2, 3, 4)},
        X, DX, "Out")),
    "label_smooth": ("label_smooth", lambda rng: (
        X, OUT, {"epsilon": 0.1},
        {"x": np.eye(5, dtype="float32")[rng.randint(0, 5, 6)]},
        {}, DX, "Out")),
    "label_smooth_prior": ("label_smooth", lambda rng: (
        {"X": ["x"], "PriorDist": ["p"]}, OUT, {"epsilon": 0.2},
        {"x": np.eye(4, dtype="float32")[rng.randint(0, 4, 5)],
         "p": rng.dirichlet(np.ones(4)).astype("float32")[None]},
        {}, DX, "Out")),
    "l1_norm": ("l1_norm", lambda rng: (
        X, OUT, {}, {"x": f32(rng, 4, 5)}, X, DX, "Out")),
    "conv_shift": ("conv_shift", lambda rng: (
        {"X": ["x"], "Y": ["y"]}, OUT, {},
        {"x": f32(rng, 3, 9), "y": f32(rng, 3, 5)},
        {"X": ["x"], "Y": ["y"]}, {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]},
        "Out")),
    "modified_huber_loss": ("modified_huber_loss", lambda rng: (
        {"X": ["x"], "Y": ["y"]},
        {"Out": ["out"], "IntermediateVal": ["inter"]}, {},
        {"x": f32(rng, 10, 1, scale=2.0),
         "y": rng.randint(0, 2, (10, 1)).astype("float32")},
        {"Y": ["y"], "IntermediateVal": ["inter"]}, DX, "Out")),
    "conv3d_transpose": ("conv3d_transpose", _conv(
        {"strides": [2, 1, 2], "paddings": [1, 0, 1],
         "dilations": [1, 2, 1]}, (2, 3, 3, 4, 3), (3, 2, 3, 2, 3))),
    "cumsum": ("cumsum", lambda rng: (
        X, OUT, {"axis": 1, "exclusive": True, "reverse": True},
        {"x": f32(rng, 3, 6, 2)}, {}, {}, None)),
    "prelu": ("prelu", lambda rng: (
        {"X": ["x"], "Alpha": ["a"]}, OUT, {},
        {"x": f32(rng, 3, 4, 2), "a": np.array([0.3], "float32")},
        {"X": ["x"], "Alpha": ["a"]},
        {"X@GRAD": ["dx"], "Alpha@GRAD": ["da"]}, "Out")),
    "spp_max": ("spp", lambda rng: (
        X, OUT, {"pyramid_height": 3, "pooling_type": "max"},
        {"x": f32(rng, 2, 3, 7, 5)}, X, DX, "Out")),
    "spp_avg": ("spp", lambda rng: (
        X, OUT, {"pyramid_height": 2, "pooling_type": "avg"},
        {"x": f32(rng, 2, 3, 6, 9)}, X, DX, "Out")),
    "norm": ("norm", lambda rng: (
        {"X": ["x"], "Scale": ["s"]}, OUT, {"epsilon": 1e-10},
        {"x": f32(rng, 2, 5, 3, 4), "s": f32(rng, 5) + 2.0},
        {"X": ["x"], "Scale": ["s"]},
        {"X@GRAD": ["dx"], "Scale@GRAD": ["ds"]}, "Out")),
    "margin_rank_loss": ("margin_rank_loss", lambda rng: (
        {"Label": ["l"], "X1": ["a"], "X2": ["b"]}, OUT, {"margin": 0.1},
        {"l": np.where(rng.rand(8, 1) < 0.5, -1.0, 1.0).astype("float32"),
         "a": f32(rng, 8, 1), "b": f32(rng, 8, 1)},
        {"Label": ["l"], "X1": ["a"], "X2": ["b"]},
        {"X1@GRAD": ["da"], "X2@GRAD": ["db"]}, "Out")),
    "bilinear_tensor_product": ("bilinear_tensor_product", lambda rng: (
        {"X": ["x"], "Y": ["y"], "Weight": ["w"], "Bias": ["b"]}, OUT, {},
        {"x": f32(rng, 4, 3), "y": f32(rng, 4, 5), "w": f32(rng, 6, 3, 5),
         "b": f32(rng, 1, 6)},
        {"X": ["x"], "Y": ["y"], "Weight": ["w"], "Bias": ["b"]},
        {"X@GRAD": ["dx"], "Y@GRAD": ["dy"], "Weight@GRAD": ["dw"],
         "Bias@GRAD": ["db"]}, "Out")),
    "bilinear_tensor_product_no_bias": ("bilinear_tensor_product",
                                        lambda rng: (
        {"X": ["x"], "Y": ["y"], "Weight": ["w"]}, OUT, {},
        {"x": f32(rng, 4, 3), "y": f32(rng, 4, 2), "w": f32(rng, 2, 3, 2)},
        {"X": ["x"], "Y": ["y"], "Weight": ["w"]},
        {"X@GRAD": ["dx"], "Y@GRAD": ["dy"], "Weight@GRAD": ["dw"]},
        "Out")),
    "conv3d": ("conv3d", _conv(
        {"strides": [1, 2, 1], "paddings": [1, 1, 0], "dilations": [1, 1, 2],
         "groups": 2}, (2, 4, 5, 6, 7), (6, 2, 3, 3, 2))),
    "pool3d_max": ("pool3d", lambda rng: (
        X, OUT, {"ksize": [2, 3, 2], "strides": [2, 1, 2],
                 "paddings": [1, 1, 0], "pooling_type": "max"},
        {"x": f32(rng, 2, 3, 5, 6, 4)}, X, DX, "Out")),
    "pool3d_avg": ("pool3d", lambda rng: (
        X, OUT, {"ksize": [3, 3, 3], "strides": [1, 2, 2],
                 "paddings": [1, 0, 1], "pooling_type": "avg"},
        {"x": f32(rng, 2, 2, 4, 5, 6)}, X, DX, "Out")),
    "pool3d_global": ("pool3d", lambda rng: (
        X, OUT, {"ksize": [1, 1, 1], "pooling_type": "avg",
                 "global_pooling": True},
        {"x": f32(rng, 2, 3, 3, 4, 5)}, X, DX, "Out")),
    "depthwise_conv2d": ("depthwise_conv2d", _conv(
        {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 6}, (2, 6, 9, 8), (6, 1, 3, 3))),
    "depthwise_conv2d_multiplier": ("depthwise_conv2d", _conv(
        {"strides": [1, 1], "paddings": [0, 1], "dilations": [2, 1],
         "groups": 3}, (2, 3, 7, 6), (6, 1, 3, 3))),
    "conv2d_transpose": ("conv2d_transpose", _conv(
        {"strides": [2, 2], "paddings": [1, 0], "dilations": [1, 1]},
        (2, 4, 5, 6), (4, 3, 3, 4))),
    "conv2d_transpose_dilated": ("conv2d_transpose", _conv(
        {"strides": [1, 3], "paddings": [0, 1], "dilations": [2, 1]},
        (1, 2, 4, 3), (2, 5, 2, 3))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_grad_match_the_reference(case):
    op_type, build = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    ins, outs, attrs, feeds, gins, gouts, cot = build(rng)
    if cot is None:
        op_both(op_type, ins, outs, attrs, feeds)
    else:
        fwd_grad(op_type, ins, outs, attrs, feeds, gins, gouts, rng, cot)


# ---------------------------------------------------------------------------
# the ops without a grad
# ---------------------------------------------------------------------------

def test_minus_and_its_scale_grads():
    rng = np.random.RandomState(1)
    op_both("minus", {"X": ["x"], "Y": ["y"]}, OUT, {},
            {"x": f32(rng, 3, 4), "y": f32(rng, 3, 4)})


@pytest.mark.parametrize("kind", ["max_pool2d_with_index",
                                  "max_pool3d_with_index",
                                  "max_pool3d_with_index_padded",
                                  "max_pool3d_with_index_global"])
def test_max_pool_with_index(kind):
    rng = np.random.RandomState(2)
    if kind == "max_pool2d_with_index":
        feeds = {"x": f32(rng, 2, 3, 7, 8)}
        attrs = {"ksize": [2, 3], "strides": [2, 2]}
    else:
        feeds = {"x": f32(rng, 2, 2, 5, 6, 7)}
        attrs = {"ksize": [2, 3, 2], "strides": [1, 2, 2],
                 "paddings": [1, 1, 0] if kind.endswith("padded")
                 else [0, 0, 0],
                 "global_pooling": kind.endswith("global")}
    op_both(kind.split("_index")[0] + "_index", X,
            {"Out": ["out"], "Mask": ["mask"]}, attrs, feeds)


def test_unpool_after_max_pool2d_with_index():
    """The pool's Mask scattered back by unpool, and unpool_grad."""
    rng = np.random.RandomState(3)
    feeds = {"x": f32(rng, 2, 3, 6, 8)}
    out, mask = op_both("max_pool2d_with_index", X,
                        {"Out": ["out"], "Mask": ["mask"]},
                        {"ksize": [2, 2], "strides": [2, 2]}, feeds)
    fwd_grad("unpool", {"X": ["p"], "Indices": ["m"]}, OUT,
             {"unpooled_size": [6, 8]}, {"p": out, "m": mask},
             {"Indices": ["m"]}, DX, rng)


def test_is_empty():
    for shape in ((0, 3), (2, 3)):
        (got,) = op_both("is_empty", X, OUT, {},
                         {"x": np.zeros(shape, "float32")})
        assert bool(got.reshape(-1)[0]) == (shape[0] == 0)


def _accumulates(num_updates, num_acc, rng):
    feeds = {"param": f32(rng, 3, 2), "s1": f32(rng, 3, 2),
             "s2": f32(rng, 3, 2), "s3": f32(rng, 3, 2),
             "nu": np.array([num_updates], np.int64),
             "na": np.array([num_acc], np.int64),
             "ona": np.array([7], np.int64)}
    ins = {"param": ["param"], "in_sum_1": ["s1"], "in_sum_2": ["s2"],
           "in_sum_3": ["s3"], "in_num_updates": ["nu"],
           "in_num_accumulates": ["na"], "in_old_num_accumulates": ["ona"]}
    outs = {"out_sum_1": ["o1"], "out_sum_2": ["o2"], "out_sum_3": ["o3"],
            "out_num_updates": ["onu"], "out_num_accumulates": ["ona2"],
            "out_old_num_accumulates": ["oona"]}
    return ins, outs, feeds


@pytest.mark.parametrize("num_updates,num_acc", [
    (5, 3), (16383, 20), (200, 99)], ids=["accumulate", "fold_16384",
                                          "window_full"])
def test_average_accumulates(num_updates, num_acc):
    ins, outs, feeds = _accumulates(num_updates, num_acc,
                                    np.random.RandomState(4))
    op_both("average_accumulates", ins, outs,
            {"average_window": 0.5, "max_average_window": 10000,
             "min_average_window": 50}, feeds)


@pytest.mark.parametrize("op_type", ["uniform_random_batch_size_like",
                                     "gaussian_random_batch_size_like"])
def test_random_batch_size_like(op_type):
    """The batch dim from Input, the draws from the executor's generator
    (the packages' generators differ: the shapes and the draws' law are
    held, not the values)."""
    attrs = {"shape": [-1, 500, 3], "input_dim_idx": 1,
             "output_dim_idx": 0, "dtype": "float32",
             **({"min": -2.0, "max": 4.0} if "uniform" in op_type
                else {"mean": 1.0, "std": 2.0})}
    feeds = {"x": np.zeros((5, 7), "float32")}
    (got,) = run_op(tfluid, op_type, {"Input": ["x"]}, OUT, attrs, feeds)
    (want,) = run_op(jfluid, op_type, {"Input": ["x"]}, OUT, attrs, feeds)
    assert got.shape == want.shape == (7, 500, 3)
    if "uniform" in op_type:
        assert got.min() >= -2.0 and got.max() < 4.0
        assert abs(got.mean() - 1.0) < 0.1
    else:
        assert abs(got.mean() - 1.0) < 0.1 and abs(got.std() - 2.0) < 0.1


@pytest.mark.parametrize("op_type", ["proximal_gd", "proximal_adagrad"])
def test_proximal_optimizers(op_type):
    rng = np.random.RandomState(5)
    feeds = {"p": f32(rng, 4, 3), "g": f32(rng, 4, 3),
             "lr": np.array([0.1], "float32")}
    ins = {"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]}
    outs = {"ParamOut": ["p"]}
    if op_type == "proximal_adagrad":
        feeds["m"] = np.abs(f32(rng, 4, 3)) + 0.1
        ins["Moment"] = ["m"]
        outs["MomentOut"] = ["m"]
    op_both(op_type, ins, outs, {"l1": 0.05, "l2": 0.1}, feeds)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _layers_program(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = layers.data("img", shape=[3, 8, 8])
        up = layers.conv2d_transpose(img, num_filters=4, filter_size=3,
                                     stride=2, padding=1, act="relu")
        dw = layers.conv2d(up, num_filters=4, filter_size=3, groups=4)
        n = layers.prelu(layers.norm(dw))
        # the pools with an index have no grad: they read the data only
        pooled, mask = layers.max_pool2d_with_index(img, pool_size=2)
        un = layers.unpool(pooled, mask, [8, 8])
        s = layers.spp(n, pyramid_height=2, pool_type="avg")
        g = layers.pool2d(un, pool_type="avg", global_pooling=True)
        vol = layers.reshape(up, [-1, 2, 2, 15, 15])
        t3 = layers.conv3d_transpose(vol, num_filters=2, filter_size=2)
        c3 = layers.conv3d(t3, num_filters=2, filter_size=2, act="tanh")
        p3 = layers.pool3d(c3, pool_size=2, pool_type="avg", pool_stride=2)
        cube = layers.data("cube", shape=[2, 4, 6, 6])
        m3, _ = layers.max_pool3d_with_index(cube, pool_size=2)
        feat = layers.concat([layers.reshape(s, [-1, 20]),
                              layers.reshape(p3, [-1, 98]),
                              layers.reshape(m3, [-1, 36]),
                              layers.reshape(g, [-1, 3])], axis=1)
        x = layers.fc(feat, 6)
        y = layers.fc(feat, 5)
        bil = layers.bilinear_tensor_product(x, y, size=3)
        label = layers.data("label", shape=[3])
        smooth = layers.label_smooth(label, epsilon=0.1)
        soft = layers.cumsum(layers.expand(bil, [1, 2]), axis=1)
        cost = layers.square_error_cost(
            layers.fc(soft, 3), layers.elementwise_mul(smooth, smooth))
        left, right = layers.fc(feat, 1), layers.fc(feat, 1)
        rank = layers.data("rank", shape=[1])
        mr = layers.margin_rank_loss(rank, left, right, margin=0.1)
        loss = layers.elementwise_add(layers.mean(cost), layers.mean(mr))
        fluid.optimizer.SGD(0.05).minimize(loss, startup)
    return main, startup, loss


def test_layers_build_the_reference_program_and_train_alike():
    progs = build_both(_layers_program)
    assert_same_program(progs["port"][0], progs["ref"][0])
    rng = np.random.RandomState(6)
    feed = {"img": rng.rand(3, 3, 8, 8).astype("float32"),
            "cube": rng.rand(3, 2, 4, 6, 6).astype("float32"),
            "label": np.eye(3, dtype="float32")[rng.randint(0, 3, 3)],
            "rank": np.where(rng.rand(3, 1) < 0.5, -1, 1).astype("float32")}
    got, _ = cross_losses(progs, feed, steps=4)
    assert got[-1] < got[0]


def test_is_empty_layer():
    progs = build_both(lambda f: _is_empty_program(f))
    assert_same_program(progs["port"][0], progs["ref"][0])


def _is_empty_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3])
        e = fluid.layers.is_empty(x)
        r = fluid.layers.uniform_random_batch_size_like(x, [-1, 4])
        g = fluid.layers.gaussian_random_batch_size_like(x, [-1, 2])
    return main, startup, (e, r, g)


# ---------------------------------------------------------------------------
# the conv family under AMP (the reference's cast_compute sites:
# conv_ops.py:247, :264, :317, breadth_ops.py:336, misc_ops.py:546)
# ---------------------------------------------------------------------------

AMP_CONVS = ["conv3d", "conv3d_transpose", "depthwise_conv2d",
             "conv2d_transpose"]


def _amp_run(fluid, op_type, attrs, feeds):
    prog = fluid.Program()
    block = prog.global_block()
    for name, arr in feeds.items():
        block.create_var(name=name, shape=arr.shape, dtype="float32")
    for name in ("out", "dx", "dw"):
        block.create_var(name=name)
    block.append_op(op_type, CONV_IN, CONV_OUT, attrs)
    block.append_op(op_type + "_grad", {**CONV_IN, "Output@GRAD": ["dy"]},
                    CONV_GRAD, attrs)
    exe = fluid.Executor(fluid.CPUPlace(), mode="eager", amp=True) \
        if fluid is jfluid else fluid.Executor(fluid.CPUPlace(), amp=True)
    out = exe.run(prog, feed=feeds, fetch_list=["out", "dx", "dw"],
                  scope=fluid.Scope(), return_numpy=False)
    return ([v.float().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v).astype(np.float32) for v in out],
            [str(v.dtype).split(".")[-1] for v in out])


@pytest.mark.parametrize("case", AMP_CONVS)
def test_conv_family_computes_in_bf16_at_the_reference_sites(case):
    """Output in bfloat16, Input@GRAD in the dtype the reference gives it
    (bfloat16 where it casts dx, float32 where its vjp returns the
    primal's), Filter@GRAD float32; values within one bfloat16 step of the
    largest (products of bf16 operands summed in float32)."""
    _, build = CASES[case]
    rng = np.random.RandomState(7)
    _, _, attrs, feeds, _, _, _ = build(rng)
    got_out = run_op(tfluid, case, CONV_IN, CONV_OUT, attrs, feeds)[0]
    feeds["dy"] = f32(rng, *got_out.shape)
    got, got_dt = _amp_run(tfluid, case, attrs, feeds)
    want, want_dt = _amp_run(jfluid, case, attrs, feeds)
    assert got_dt == want_dt and got_dt[0] == "bfloat16" \
        and got_dt[2] == "float32", (got_dt, want_dt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2.0 ** -8 * np.abs(w).max())
