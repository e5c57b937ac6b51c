"""Each op the port's serving path runs, against the reference's op on the
same numpy inputs.

One single-op program is built with each package's IR and run by each
package's executor on the CPU: conv2d, pool2d, batch_norm (inference mode),
elementwise_add (the axis rule), relu, softmax and mul.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

# float32 ops; the two packages may order a conv's or a matmul's sums
# differently, which moves results by a few float32 rounding steps
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_port():
    from paddle_tpu_torch.fluid import framework
    framework.reset_unique_name()
    yield


def _run(fluid, op_type, inputs, outputs, attrs):
    """Run one op. ``inputs``: slot -> (name, array); ``outputs``: slot ->
    name. Returns {name: np.ndarray} for every output."""
    prog = fluid.Program()
    block = prog.global_block()
    for name, arr in inputs.values():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
    for name in outputs.values():
        block.create_var(name=name)
    block.append_op(op_type,
                    inputs={s: [n] for s, (n, _) in inputs.items()},
                    outputs={s: [n] for s, n in outputs.items()},
                    attrs=attrs)
    exe = fluid.Executor(fluid.CPUPlace())
    names = list(outputs.values())
    vals = exe.run(prog, feed={n: a for n, a in inputs.values()},
                   fetch_list=names, scope=fluid.Scope())
    return dict(zip(names, (np.asarray(v) for v in vals)))


def _check(op_type, inputs, outputs, attrs, tol=TOL):
    want = _run(jfluid, op_type, inputs, outputs, attrs)
    got = _run(tfluid, op_type, inputs, outputs, attrs)
    for name in outputs.values():
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], **tol,
                                   err_msg=name)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).normal(0, 1, shape).astype("float32")


@pytest.mark.parametrize("case", [
    dict(df="NHWC", k=3, s=1, p=1, d=1, g=1),
    dict(df="NHWC", k=3, s=2, p=1, d=1, g=1),
    dict(df="NHWC", k=1, s=2, p=0, d=1, g=1),
    dict(df="NHWC", k=7, s=2, p=3, d=1, g=1),     # the ResNet stem
    dict(df="NCHW", k=3, s=1, p=2, d=2, g=2),
])
def test_conv2d(case):
    cin, cout = 4, 6
    x = _rand(2, 11, 10, cin, seed=1) if case["df"] == "NHWC" \
        else _rand(2, cin, 11, 10, seed=1)
    w = _rand(cout, cin // case["g"], case["k"], case["k"], seed=2)
    _check("conv2d", {"Input": ("x", x), "Filter": ("w", w)},
           {"Output": "y"},
           {"strides": [case["s"]] * 2, "paddings": [case["p"]] * 2,
            "dilations": [case["d"]] * 2, "groups": case["g"],
            "data_format": case["df"]})


@pytest.mark.parametrize("attrs", [
    dict(pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
    dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
    dict(pooling_type="avg", ksize=[7, 7], global_pooling=True),
    dict(pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[0, 0],
         ceil_mode=True),
    dict(pooling_type="avg", ksize=[2, 2], strides=[2, 2], paddings=[1, 1],
         ceil_mode=True),
])
@pytest.mark.parametrize("df", ["NHWC", "NCHW"])
def test_pool2d(attrs, df):
    x = _rand(2, 8, 7, 3, seed=3) if df == "NHWC" else _rand(2, 3, 8, 7,
                                                              seed=3)
    _check("pool2d", {"X": ("x", x)}, {"Out": "y"},
           {**attrs, "data_format": df})


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_batch_norm_inference(layout):
    c = 5
    x = _rand(3, 4, 6, c, seed=4) if layout == "NHWC" else _rand(3, c, 4, 6,
                                                                  seed=4)
    rng = np.random.RandomState(5)
    scale, bias = (rng.uniform(0.5, 1.5, c).astype("float32"),
                   rng.normal(0, 0.2, c).astype("float32"))
    mean, var = (rng.normal(0, 0.3, c).astype("float32"),
                 rng.uniform(0.5, 2.0, c).astype("float32"))
    _check("batch_norm",
           {"X": ("x", x), "Scale": ("s", scale), "Bias": ("b", bias),
            "Mean": ("m", mean), "Variance": ("v", var)},
           {"Y": "y", "MeanOut": "m", "VarianceOut": "v",
            "SavedMean": "sm", "SavedVariance": "sv"},
           {"epsilon": 1e-5, "momentum": 0.9, "is_test": True,
            "data_layout": layout})


@pytest.mark.parametrize("x_shape,y_shape,axis", [
    ((2, 3, 4, 5), (2, 3, 4, 5), -1),     # same shape
    ((2, 3, 4, 5), (5,), -1),             # NHWC channel bias
    ((2, 5, 4, 3), (5,), 1),              # NCHW channel bias
    ((2, 3, 4, 5), (3, 4), 1),            # a middle span
    ((6, 10), (10,), 1),                  # fc bias (append_bias_op)
])
def test_elementwise_add_axis_rule(x_shape, y_shape, axis):
    _check("elementwise_add",
           {"X": ("x", _rand(*x_shape, seed=6)),
            "Y": ("y", _rand(*y_shape, seed=7))},
           {"Out": "out"}, {"axis": axis})


def test_relu():
    _check("relu", {"X": ("x", _rand(4, 9, seed=8))}, {"Out": "y"}, {})


def test_softmax():
    _check("softmax", {"X": ("x", 4 * _rand(5, 17, seed=9))}, {"Out": "y"},
           {}, tol=dict(rtol=1e-5, atol=1e-7))


@pytest.mark.parametrize("x_shape,y_shape,xnc", [
    ((4, 1, 1, 30), (30, 7), 1),          # fc over a pooled NHWC map
    ((4, 2, 3, 5), (15, 7), 2),
])
def test_mul(x_shape, y_shape, xnc):
    _check("mul", {"X": ("x", _rand(*x_shape, seed=10)),
                   "Y": ("w", _rand(*y_shape, seed=11))},
           {"Out": "out"}, {"x_num_col_dims": xnc, "y_num_col_dims": 1})


def test_startup_ops_shapes_and_ranges():
    """fill_constant, uniform_random and gaussian_random: the port draws from
    a torch.Generator seeded by ``random_seed`` (not jax's draws), so the
    check is shape, dtype, range, and determinism per seed."""
    def run(seed):
        prog = tfluid.Program()
        prog.random_seed = seed
        block = prog.global_block()
        for n in ("c", "u", "g"):
            block.create_var(name=n, persistable=True)
        block.append_op("fill_constant", outputs={"Out": ["c"]},
                        attrs={"shape": [3, 2], "value": 1.5,
                               "dtype": "float32"})
        block.append_op("uniform_random", outputs={"Out": ["u"]},
                        attrs={"shape": [400], "min": -0.5, "max": 0.25,
                               "dtype": "float32"})
        block.append_op("gaussian_random", outputs={"Out": ["g"]},
                        attrs={"shape": [4000], "mean": 2.0, "std": 0.5,
                               "dtype": "float32"})
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(prog, scope=scope)
        return [scope.find_var(n).numpy() for n in ("c", "u", "g")]

    c, u, g = run(7)
    assert c.shape == (3, 2) and (c == 1.5).all() and c.dtype == np.float32
    assert u.min() >= -0.5 and u.max() < 0.25 and u.std() > 0.15
    assert abs(g.mean() - 2.0) < 0.05 and abs(g.std() - 0.5) < 0.05
    again = run(7)
    other = run(8)
    np.testing.assert_array_equal(u, again[1])
    assert not np.array_equal(u, other[1])
