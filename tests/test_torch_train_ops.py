"""The port's training ops against the reference's, one op at a time.

Each op runs as a one-op program in each package on the same numpy inputs
(``_run_op``), on the CPU, and the fetched outputs are compared: the
forward ops of the training slice and every grad op the ResNet-50 training
program appends, plus batch_norm in training mode and the momentum update.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

# float32 elementwise work: both packages round the same float32 operations
# the same way, up to sums taken in another order (XLA vs PyTorch's CPU
# kernels), a few float32 steps of the largest term
TOL = dict(rtol=1e-5, atol=1e-6)
# convolutions and their grads sum K = kh*kw*Cin (or N*H*W) products in
# another order: the repo's fused-kernel tolerance
CONV_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _tiers():
    jfluid.set_flags({"kernel_tier": "jnp"})
    tfluid.set_flags({"kernel_tier": "torch"})
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _run_op(fluid, op_type, inputs, outputs, attrs, feeds):
    """Run one op over ``feeds`` in ``fluid``'s package; returns the
    values of every output name, in slot order."""
    prog = fluid.Program()
    block = prog.global_block()
    for name, arr in feeds.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
    fetch = [n for names in outputs.values() for n in names]
    for n in fetch:
        if not block.has_var(n):
            block.create_var(name=n)
    block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    exe = fluid.Executor(fluid.CPUPlace())
    return [np.asarray(v) for v in exe.run(prog, feed=feeds,
                                           fetch_list=fetch,
                                           scope=fluid.Scope())]


def _both(op_type, inputs, outputs, attrs, feeds, tol=TOL):
    want = _run_op(jfluid, op_type, inputs, outputs, attrs, feeds)
    got = _run_op(tfluid, op_type, inputs, outputs, attrs, feeds)
    names = [n for ns in outputs.values() for n in ns]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, (op_type, name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{op_type} {name}")
    return got


def _rng(seed=0):
    return np.random.RandomState(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(0, scale, shape)).astype("float32")


def test_softmax_with_cross_entropy_and_grad():
    rng = _rng(1)
    feeds = {"logits": _f32(rng, 6, 10, scale=3.0),
             "label": rng.randint(0, 10, (6, 1)).astype("int64")}
    sm, _ = _both("softmax_with_cross_entropy",
                  {"Logits": ["logits"], "Label": ["label"]},
                  {"Softmax": ["sm"], "Loss": ["loss"]},
                  {"soft_label": False}, feeds)
    _both("softmax_with_cross_entropy_grad",
          {"Softmax": ["sm"], "Label": ["label"], "Loss@GRAD": ["dloss"]},
          {"Logits@GRAD": ["dlogits"]}, {"soft_label": False},
          {"sm": sm, "label": feeds["label"],
           "dloss": _f32(rng, 6, 1)})


def test_mean_and_grad():
    rng = _rng(2)
    x = _f32(rng, 4, 5)
    _both("mean", {"X": ["x"]}, {"Out": ["out"]}, {}, {"x": x})
    _both("mean_grad", {"X": ["x"], "Out@GRAD": ["d"]}, {"X@GRAD": ["dx"]},
          {}, {"x": x, "d": np.float32(0.37).reshape(())})


def test_sum_and_fill_zeros_like():
    rng = _rng(3)
    feeds = {n: _f32(rng, 3, 4) for n in ("a", "b", "c")}
    _both("sum", {"X": ["a", "b", "c"]}, {"Out": ["out"]}, {}, feeds)
    got = _both("fill_zeros_like", {"X": ["a"]}, {"Out": ["z"]}, {},
                {"a": feeds["a"]})
    assert not got[0].any()


@pytest.mark.parametrize("yshape,axis", [((5, 10), -1), ((10,), 1)],
                         ids=["same_shape", "fc_bias_axis1"])
def test_elementwise_add_and_grad(yshape, axis):
    rng = _rng(4)
    feeds = {"x": _f32(rng, 5, 10), "y": _f32(rng, *yshape)}
    out, = _both("elementwise_add", {"X": ["x"], "Y": ["y"]},
                 {"Out": ["out"]}, {"axis": axis}, feeds)
    _both("elementwise_add_grad",
          {"X": ["x"], "Y": ["y"], "Out": ["out"], "Out@GRAD": ["d"]},
          {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, {"axis": axis},
          {**feeds, "out": out, "d": _f32(rng, 5, 10)})


def test_relu_and_grad():
    rng = _rng(5)
    x = _f32(rng, 4, 6)
    out, = _both("relu", {"X": ["x"]}, {"Out": ["out"]}, {}, {"x": x})
    _both("relu_grad", {"Out": ["out"], "Out@GRAD": ["d"]},
          {"X@GRAD": ["dx"]}, {}, {"out": out, "d": _f32(rng, 4, 6)})


@pytest.mark.parametrize("yshape,axis", [((5, 10), -1), ((10,), 1)],
                         ids=["same_shape", "fc_bias_axis1"])
def test_elementwise_sub_and_grad(yshape, axis):
    rng = _rng(14)
    feeds = {"x": _f32(rng, 5, 10), "y": _f32(rng, *yshape)}
    out, = _both("elementwise_sub", {"X": ["x"], "Y": ["y"]},
                 {"Out": ["out"]}, {"axis": axis}, feeds)
    _both("elementwise_sub_grad",
          {"X": ["x"], "Y": ["y"], "Out": ["out"], "Out@GRAD": ["d"]},
          {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, {"axis": axis},
          {**feeds, "out": out, "d": _f32(rng, 5, 10)})


@pytest.mark.parametrize("act,ref", [("sigmoid", "Out"), ("square", "X")])
def test_activation_and_grad(act, ref):
    """The activation table's other entries; each grad reads Out or X as
    the reference's grad functor does."""
    rng = _rng(15)
    x = _f32(rng, 4, 6)
    out, = _both(act, {"X": ["x"]}, {"Out": ["out"]}, {}, {"x": x})
    refs = {"Out": ("out", out), "X": ("x", x)}
    name, value = refs[ref]
    _both(act + "_grad", {ref: [name], "Out@GRAD": ["d"]},
          {"X@GRAD": ["dx"]}, {}, {name: value, "d": _f32(rng, 4, 6)})


def test_concat_and_grad():
    """The word2vec model's concat of its 4 context embeddings (axis 1)
    and the grad's split."""
    rng = _rng(16)
    feeds = {f"e{i}": _f32(rng, 5, 3) for i in range(4)}
    names = sorted(feeds)
    out, = _both("concat", {"X": names}, {"Out": ["out"]}, {"axis": 1},
                 feeds)
    assert out.shape == (5, 12)
    _both("concat_grad", {"X": names, "Out@GRAD": ["d"]},
          {"X@GRAD": [n + "@G" for n in names]}, {"axis": 1},
          {**feeds, "d": _f32(rng, 5, 12)})


def test_mul_and_grad():
    rng = _rng(6)
    feeds = {"x": _f32(rng, 4, 2, 1, 3), "y": _f32(rng, 6, 5)}
    attrs = {"x_num_col_dims": 1, "y_num_col_dims": 1}
    _both("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]}, attrs, feeds)
    _both("mul_grad", {"X": ["x"], "Y": ["y"], "Out@GRAD": ["d"]},
          {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, attrs,
          {**feeds, "d": _f32(rng, 4, 5)})


POOLS = {
    "max3s2p1": {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                 "paddings": [1, 1], "global_pooling": False,
                 "ceil_mode": False, "data_format": "NHWC"},
    "global_avg": {"pooling_type": "avg", "ksize": [7, 7],
                   "strides": [1, 1], "paddings": [0, 0],
                   "global_pooling": True, "ceil_mode": False,
                   "data_format": "NHWC"},
}


@pytest.mark.parametrize("relu_input", [False, True],
                         ids=["distinct", "relu_ties"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_pool2d_grad(pool, relu_input):
    """With a relu'd input a max window often holds several equal maxima
    (zeros): both packages send the gradient to the window's first one."""
    rng = _rng(7)
    x = _f32(rng, 2, 9, 9, 4)
    if relu_input:
        x = np.maximum(x, 0)
    attrs = POOLS[pool]
    out, = _both("pool2d", {"X": ["x"]}, {"Out": ["out"]}, attrs, {"x": x})
    _both("pool2d_grad", {"X": ["x"], "Out@GRAD": ["d"]},
          {"X@GRAD": ["dx"]}, attrs, {"x": x, "d": _f32(rng, *out.shape)})


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (7, 2, 3), (1, 2, 0)])
def test_conv2d_grad(k, stride, pad):
    rng = _rng(8)
    x = _f32(rng, 2, 9, 9, 5)
    w = _f32(rng, 6, 5, k, k, scale=0.3)
    attrs = {"strides": [stride, stride], "paddings": [pad, pad],
             "dilations": [1, 1], "groups": 1, "data_format": "NHWC"}
    out, = _both("conv2d", {"Input": ["x"], "Filter": ["w"]},
                 {"Output": ["out"]}, attrs, {"x": x, "w": w}, CONV_TOL)
    _both("conv2d_grad",
          {"Input": ["x"], "Filter": ["w"], "Output@GRAD": ["d"]},
          {"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"]}, attrs,
          {"x": x, "w": w, "d": _f32(rng, *out.shape)}, CONV_TOL)


BN_OUT = {"Y": ["y"], "MeanOut": ["rm"], "VarianceOut": ["rv"],
          "SavedMean": ["sm"], "SavedVariance": ["sv"]}


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_batch_norm_training_and_grad(layout):
    rng = _rng(9)
    x = _f32(rng, 3, 5, 4, 6) * 2 + 0.5
    c = x.shape[-1] if layout == "NHWC" else x.shape[1]
    feeds = {"x": x, "scale": rng.uniform(0.5, 1.5, c).astype("float32"),
             "bias": _f32(rng, c), "rm": _f32(rng, c),
             "rv": rng.uniform(0.5, 1.5, c).astype("float32")}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
             "data_layout": layout}
    y, _, _, sm, sv = _both(
        "batch_norm", {"X": ["x"], "Scale": ["scale"], "Bias": ["bias"],
                       "Mean": ["rm"], "Variance": ["rv"]},
        BN_OUT, attrs, feeds)
    _both("batch_norm_grad",
          {"X": ["x"], "Scale": ["scale"], "SavedMean": ["sm"],
           "SavedVariance": ["sv"], "Y@GRAD": ["dy"]},
          {"X@GRAD": ["dx"], "Scale@GRAD": ["dscale"],
           "Bias@GRAD": ["dbias"]}, attrs,
          {"x": x, "scale": feeds["scale"], "sm": sm, "sv": sv,
           "dy": _f32(rng, *y.shape)})


@pytest.mark.parametrize("act", ["", "relu"])
def test_fused_conv2d_bn_training_and_grad(act):
    """The fused op and its grad on their plain routes (kernel_tier=torch
    here, jnp in the reference)."""
    rng = _rng(10)
    feeds = {"x": _f32(rng, 2, 6, 6, 4), "w": _f32(rng, 8, 4, 3, 3,
                                                   scale=0.3),
             "scale": rng.uniform(0.5, 1.5, 8).astype("float32"),
             "bias": _f32(rng, 8, scale=0.1), "rm": _f32(rng, 8),
             "rv": rng.uniform(0.5, 1.5, 8).astype("float32")}
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1, "data_format": "NHWC", "momentum": 0.9,
             "epsilon": 1e-5, "is_test": False, "data_layout": "NHWC",
             "act": act}
    out = {**BN_OUT, "Output": ["y"]}
    del out["Y"]
    y, _, _, sm, sv = _both(
        "fused_conv2d_bn", {"Input": ["x"], "Filter": ["w"],
                            "Scale": ["scale"], "Bias": ["bias"],
                            "Mean": ["rm"], "Variance": ["rv"]},
        {k: out[k] for k in ("Output", "MeanOut", "VarianceOut",
                             "SavedMean", "SavedVariance")},
        attrs, feeds, CONV_TOL)
    _both("fused_conv2d_bn_grad",
          {"Input": ["x"], "Filter": ["w"], "Scale": ["scale"],
           "Bias": ["bias"], "SavedMean": ["sm"], "SavedVariance": ["sv"],
           "Output": ["y"], "Output@GRAD": ["dy"]},
          {"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"],
           "Scale@GRAD": ["dscale"], "Bias@GRAD": ["dbias"]}, attrs,
          {"x": feeds["x"], "w": feeds["w"], "scale": feeds["scale"],
           "bias": feeds["bias"], "sm": sm, "sv": sv, "y": y,
           "dy": _f32(rng, *y.shape)}, CONV_TOL)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("op_type", ["momentum", "fused_momentum"])
def test_momentum_update(op_type, nesterov):
    """The in-place update: ParamOut/VelocityOut name the Param and the
    Velocity, as the optimizer emits them."""
    rng = _rng(11)
    shapes = [(3, 4), (7,), (2, 3, 5)]
    feeds = {"lr": np.array([0.1], "float32")}
    for i, s in enumerate(shapes):
        feeds[f"p{i}"] = _f32(rng, *s)
        feeds[f"g{i}"] = _f32(rng, *s)
        feeds[f"v{i}"] = _f32(rng, *s)
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    if op_type == "momentum":
        for i in range(len(shapes)):
            _both("momentum", {"Param": [f"p{i}"], "Grad": [f"g{i}"],
                               "Velocity": [f"v{i}"],
                               "LearningRate": ["lr"]},
                  {"ParamOut": [f"p{i}"], "VelocityOut": [f"v{i}"]}, attrs,
                  feeds)
        return
    ps = [f"p{i}" for i in range(len(shapes))]
    vs = [f"v{i}" for i in range(len(shapes))]
    _both("fused_momentum",
          {"Params": ps, "Grads": [f"g{i}" for i in range(len(shapes))],
           "Velocities": vs, "LearningRate": ["lr"]},
          {"ParamsOut": ps, "VelocitiesOut": vs}, attrs, feeds)
