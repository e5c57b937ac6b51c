"""The port's losses, reductions, matmul/cos_sim, dropout and the rest of
the tensor ops against the reference's, one op at a time on the same
seeded inputs: float32 within rtol 1e-5 / atol 1e-6 of the largest
element, integer outputs exact. Every grad op takes the forward's
outputs and a seeded cotangent in both packages.

Dropout draws its mask from another generator than the reference's
``jax.random.bernoulli``, so it is held by its rule: ``is_test`` exact,
training Out == X * Mask bitwise with a keep share within 4 sigma of
1 - p, and ``dropout_grad`` exact on one Mask fed to both."""

import numpy as np
import pytest

from torch_cross import op_both, run_op
import paddle_tpu_torch.fluid as tfluid


def _f32(rng, *shape, scale=1.0):
    return rng.normal(0, scale, shape).astype("float32")


def _fwd_grad(op_type, ins, outs, attrs, feeds, grad_ins, grad_outs, rng,
              cot="Out"):
    """The forward op, then its grad op fed the forward's outputs and a
    seeded cotangent of the ``cot`` output."""
    got = op_both(op_type, ins, outs, attrs, feeds)
    out_vals = dict(zip([n for ns in outs.values() for n in ns], got))
    d = outs[cot][0]
    gfeeds = {n: v for n, v in {**feeds, **out_vals}.items()
              if any(n in ns for ns in grad_ins.values())}
    gfeeds["d"] = _f32(rng, *np.shape(out_vals[d]))
    op_both(op_type + "_grad", {**grad_ins, cot + "@GRAD": ["d"]},
            grad_outs, attrs, gfeeds)


LOSSES = {
    "sigmoid_cross_entropy_with_logits": lambda rng: (
        {"X": ["x"], "Label": ["y"]}, {"Out": ["out"]}, {},
        {"x": _f32(rng, 6, 5, scale=3.0),
         "y": rng.rand(6, 5).astype("float32")},
        {"X": ["x"], "Label": ["y"]}, {"X@GRAD": ["dx"]}, "Out"),
    "squared_l2_distance": lambda rng: (
        {"X": ["x"], "Y": ["y"]}, {"sub_result": ["sub"], "Out": ["out"]},
        {}, {"x": _f32(rng, 6, 5), "y": _f32(rng, 6, 5)},
        {"sub_result": ["sub"]}, {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]},
        "Out"),
    "smooth_l1_loss": lambda rng: (
        {"X": ["x"], "Y": ["y"], "InsideWeight": ["iw"],
         "OutsideWeight": ["ow"]}, {"Diff": ["diff"], "Out": ["out"]},
        {"sigma": 2.0},
        {"x": _f32(rng, 6, 5), "y": _f32(rng, 6, 5),
         "iw": rng.rand(6, 5).astype("float32"),
         "ow": rng.rand(6, 5).astype("float32")},
        {"Diff": ["diff"], "InsideWeight": ["iw"], "OutsideWeight": ["ow"]},
        {"X@GRAD": ["dx"]}, "Out"),
    "log_loss": lambda rng: (
        {"Predicted": ["p"], "Labels": ["y"]}, {"Loss": ["loss"]},
        {"epsilon": 1e-4},
        {"p": rng.uniform(0.05, 0.95, (8, 1)).astype("float32"),
         "y": rng.randint(0, 2, (8, 1)).astype("float32")},
        {"Predicted": ["p"], "Labels": ["y"]}, {"Predicted@GRAD": ["dp"]},
        "Loss"),
    "hinge_loss": lambda rng: (
        {"Logits": ["x"], "Labels": ["y"]}, {"Loss": ["loss"]}, {},
        {"x": _f32(rng, 8, 1, scale=2.0),
         "y": rng.randint(0, 2, (8, 1)).astype("float32")},
        {"Logits": ["x"], "Labels": ["y"]}, {"Logits@GRAD": ["dx"]},
        "Loss"),
    "huber_loss": lambda rng: (
        {"X": ["x"], "Y": ["y"]}, {"Residual": ["r"], "Out": ["out"]},
        {"delta": 0.7}, {"x": _f32(rng, 8, 1), "y": _f32(rng, 8, 1)},
        {"Residual": ["r"]}, {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, "Out"),
    "hsigmoid": lambda rng: (
        {"X": ["x"], "W": ["w"], "Label": ["label"], "Bias": ["b"]},
        {"Out": ["out"]}, {"num_classes": 6},
        {"x": _f32(rng, 7, 4), "w": _f32(rng, 5, 4),
         "label": rng.randint(0, 6, (7, 1)).astype("int64"),
         "b": _f32(rng, 5, 1)},
        {"X": ["x"], "W": ["w"], "Label": ["label"], "Bias": ["b"]},
        {"X@GRAD": ["dx"], "W@GRAD": ["dw"], "Bias@GRAD": ["db"]}, "Out"),
}


@pytest.mark.parametrize("op_type", sorted(LOSSES))
def test_loss_and_grad(op_type):
    rng = np.random.RandomState(len(op_type))
    ins, outs, attrs, feeds, gins, gouts, cot = LOSSES[op_type](rng)
    _fwd_grad(op_type, ins, outs, attrs, feeds, gins, gouts, rng, cot)


def test_squared_l2_distance_broadcast_row_grad():
    """A one-row Y: the grad op sums Y@GRAD over the rows where the block
    declares Y@GRAD with one row."""
    import paddle_tpu.fluid as jfluid
    from torch_cross import assert_op_close
    rng = np.random.RandomState(3)
    sub, _ = op_both("squared_l2_distance", {"X": ["x"], "Y": ["y"]},
                     {"sub_result": ["sub"], "Out": ["out"]}, {},
                     {"x": _f32(rng, 6, 5), "y": _f32(rng, 1, 5)})
    d = _f32(rng, 6, 1)

    def run(fluid):
        prog = fluid.Program()
        b = prog.global_block()
        for name, shape in (("sub", (6, 5)), ("d", (6, 1)), ("dx", (6, 5)),
                            ("dy", (1, 5))):
            b.create_var(name=name, shape=shape, dtype="float32")
        b.append_op("squared_l2_distance_grad",
                    {"sub_result": ["sub"], "Out@GRAD": ["d"]},
                    {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]})
        exe = jfluid.Executor(jfluid.CPUPlace(), mode="eager") \
            if fluid is jfluid else fluid.Executor(fluid.CPUPlace())
        return exe.run(prog, feed={"sub": sub, "d": d},
                       fetch_list=["dx", "dy"], scope=fluid.Scope())

    got, want = run(tfluid), run(jfluid)
    assert np.asarray(got[1]).shape == (1, 5)
    for g, w in zip(got, want):
        assert_op_close(np.asarray(g), np.asarray(w), "squared_l2 broadcast")


REDUCE_CASES = [
    ({"dim": 1, "keep_dim": False, "reduce_all": False}, (4, 5, 3)),
    ({"dim": [0, 2], "keep_dim": True, "reduce_all": False}, (4, 5, 3)),
    ({"dim": -1, "keep_dim": True, "reduce_all": False}, (4, 5)),
    ({"dim": 0, "keep_dim": False, "reduce_all": True}, (4, 5, 3)),
]


@pytest.mark.parametrize("case", range(len(REDUCE_CASES)),
                         ids=["dim1", "dims02_keep", "dim-1_keep", "all"])
@pytest.mark.parametrize("op_type", ["reduce_sum", "reduce_mean",
                                     "reduce_max", "reduce_min",
                                     "reduce_prod"])
def test_reduce_and_grad(op_type, case):
    """Max and min inputs hold ties (values on a coarse grid), so the
    rule that every tied element takes the whole gradient is held."""
    rng = np.random.RandomState(case)
    attrs, shape = REDUCE_CASES[case]
    if op_type in ("reduce_max", "reduce_min"):
        x = rng.randint(-2, 3, shape).astype("float32")
    else:
        x = rng.uniform(0.5, 1.5, shape).astype("float32")
    _fwd_grad(op_type, {"X": ["x"]}, {"Out": ["out"]}, attrs, {"x": x},
              {"X": ["x"], "Out": ["out"]}, {"X@GRAD": ["dx"]}, rng)


def test_reduce_max_grad_gives_every_tie_the_gradient():
    x = np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]], "float32")
    out, = op_both("reduce_max", {"X": ["x"]}, {"Out": ["out"]},
                   {"dim": 1, "keep_dim": False}, {"x": x})
    dx, = op_both("reduce_max_grad",
                  {"X": ["x"], "Out": ["out"], "Out@GRAD": ["d"]},
                  {"X@GRAD": ["dx"]}, {"dim": 1, "keep_dim": False},
                  {"x": x, "out": out, "d": np.array([2.0, 5.0], "float32")})
    np.testing.assert_array_equal(dx, [[0, 2, 2], [5, 5, 5]])


MATMUL_CASES = [
    ((4, 6), (6, 3), False, False),
    ((6, 4), (6, 3), True, False),
    ((4, 6), (3, 6), False, True),
    ((6, 4), (3, 6), True, True),
    ((2, 3, 4, 6), (2, 3, 6, 5), False, False),
    ((2, 3, 4, 6), (6, 5), False, False),
    ((4, 6), (2, 6, 5), False, False),
    ((6,), (6,), False, False),
    ((6,), (6, 3), False, False),
]


@pytest.mark.parametrize("case", range(len(MATMUL_CASES)),
                         ids=["nn", "tn", "nt", "tt", "batched",
                              "batch_x_2d_y", "2d_x_batch_y", "vec_vec",
                              "vec_mat"])
def test_matmul_and_grad(case):
    """Transposes, batch dims, a batch broadcast on either side (summed
    back in the grad) and 1-D operands. The reference's vector-vector
    grad raises (its fit sums Y@GRAD's [K, 1] to [1]): there the port's
    grad is held to the outer products in numpy."""
    xs, ys, tx, ty = MATMUL_CASES[case]
    if len(xs) == len(ys) == 1:
        rng = np.random.RandomState(case)
        x, y, d = _f32(rng, *xs), _f32(rng, *ys), np.float32(0.7)
        op_both("matmul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]}, {},
                {"x": x, "y": y})
        dx, dy = run_op(tfluid, "matmul_grad",
                        {"X": ["x"], "Y": ["y"], "Out@GRAD": ["d"]},
                        {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, {},
                        {"x": x, "y": y, "d": np.asarray(d).reshape(())})
        np.testing.assert_allclose(dx, d * y, rtol=1e-6)
        np.testing.assert_allclose(dy, d * x, rtol=1e-6)
        return
    rng = np.random.RandomState(case)
    attrs = {"transpose_X": tx, "transpose_Y": ty}
    _fwd_grad("matmul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]}, attrs,
              {"x": _f32(rng, *xs), "y": _f32(rng, *ys)},
              {"X": ["x"], "Y": ["y"]}, {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]},
              rng)


@pytest.mark.parametrize("yrows", [6, 1], ids=["rowwise", "broadcast_y"])
def test_cos_sim_and_grad(yrows):
    rng = np.random.RandomState(yrows)
    feeds = {"x": _f32(rng, 6, 5), "y": _f32(rng, yrows, 5)}
    out, = op_both("cos_sim", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]},
                   {}, feeds)
    got = run_op(tfluid, "cos_sim", {"X": ["x"], "Y": ["y"]},
                 {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {}, feeds)
    np.testing.assert_allclose(got[1], np.linalg.norm(feeds["x"], axis=1,
                                                      keepdims=True),
                               rtol=1e-6)
    d = _f32(rng, 6, 1)
    dx, dy = op_both("cos_sim_grad",
                     {"X": ["x"], "Y": ["y"], "Out@GRAD": ["d"]},
                     {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, {},
                     {**feeds, "d": d})
    assert dy.shape == (yrows, 5)
    # the port's grad from the kept norms equals its grad recomputing them
    kept = run_op(tfluid, "cos_sim_grad",
                  {"X": ["x"], "Y": ["y"], "Out": ["out"], "XNorm": ["xn"],
                   "YNorm": ["yn"], "Out@GRAD": ["d"]},
                  {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, {},
                  {**feeds, "out": got[0], "xn": got[1], "yn": got[2],
                   "d": d})
    np.testing.assert_allclose(kept[0], dx, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(kept[1], dy, rtol=1e-6, atol=1e-7)


def test_dropout_is_test_is_exact():
    rng = np.random.RandomState(1)
    op_both("dropout", {"X": ["x"]}, {"Out": ["out"], "Mask": ["mask"]},
            {"dropout_prob": 0.35, "is_test": True}, {"x": _f32(rng, 8, 9)})


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5])
def test_dropout_training_rule(p):
    """Out == X * Mask bitwise (no 1/(1-p) upscale), Mask 0/1, and the keep
    share within 4 sigma of 1 - p."""
    rng = np.random.RandomState(2)
    x = _f32(rng, 64, 100)
    out, mask = run_op(tfluid, "dropout", {"X": ["x"]},
                       {"Out": ["out"], "Mask": ["mask"]},
                       {"dropout_prob": p, "is_test": False}, {"x": x})
    np.testing.assert_array_equal(out, x * mask)
    assert set(np.unique(mask)) <= {0.0, 1.0}
    keep, n = float(mask.mean()), mask.size
    sigma = np.sqrt(max(p * (1 - p), 1e-12) / n)
    assert abs(keep - (1 - p)) <= 4 * sigma, (keep, 1 - p, sigma)


def test_dropout_grad_on_one_mask_is_exact():
    rng = np.random.RandomState(3)
    mask = (rng.rand(8, 9) < 0.6).astype("float32")
    op_both("dropout_grad", {"Mask": ["mask"], "Out@GRAD": ["d"]},
            {"X@GRAD": ["dx"]}, {"dropout_prob": 0.4},
            {"mask": mask, "d": _f32(rng, 8, 9)})


def test_assign_value_and_shape():
    op_both("assign_value", {}, {"Out": ["out"]},
            {"values": [1.5, 2.0, -3.25, 4.0, 0.5, 6.0], "shape": [2, 3]}, {})
    got, = op_both("assign_value", {}, {"Out": ["out"]},
                   {"values": [3, 1, 4, 1], "shape": [4]}, {})
    np.testing.assert_array_equal(got, [3, 1, 4, 1])
    rng = np.random.RandomState(4)
    got, = run_op(tfluid, "shape", {"Input": ["x"]}, {"Out": ["out"]}, {},
                  {"x": _f32(rng, 3, 4, 5)})
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, [3, 4, 5])
    op_both("shape", {"Input": ["x"]}, {"Out": ["out"]}, {},
            {"x": _f32(rng, 3, 4, 5)})


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_gather_and_scatter(dtype):
    rng = np.random.RandomState(5)
    x = (rng.normal(0, 3, (7, 4)) if dtype == "float32"
         else rng.randint(-50, 50, (7, 4))).astype(dtype)
    idx = np.array([3, 0, 3, 6, 1], "int64")
    op_both("gather", {"X": ["x"], "Index": ["idx"]}, {"Out": ["out"]}, {},
            {"x": x, "idx": idx})
    upd = (rng.normal(0, 3, (3, 4)) if dtype == "float32"
           else rng.randint(-50, 50, (3, 4))).astype(dtype)
    op_both("scatter", {"X": ["x"], "Ids": ["ids"], "Updates": ["u"]},
            {"Out": ["out"]}, {},
            {"x": x, "ids": np.array([5, 0, 2], "int64"), "u": upd})


def test_gather_grad_sums_duplicates():
    rng = np.random.RandomState(6)
    op_both("gather_grad",
            {"X": ["x"], "Index": ["idx"], "Out@GRAD": ["d"]},
            {"X@GRAD": ["dx"]}, {},
            {"x": _f32(rng, 7, 4), "idx": np.array([3, 0, 3, 6, 3], "int64"),
             "d": _f32(rng, 5, 4)})


def test_one_hot_and_multiplex():
    rng = np.random.RandomState(7)
    op_both("one_hot", {"X": ["x"]}, {"Out": ["out"]}, {"depth": 6},
            {"x": rng.randint(0, 6, (9, 1)).astype("int64")})
    feeds = {f"x{i}": _f32(rng, 5, 3) for i in range(3)}
    feeds["ids"] = np.array([[2], [0], [1], [2], [0]], "int32")
    op_both("multiplex", {"X": ["x0", "x1", "x2"], "Ids": ["ids"]},
            {"Out": ["out"]}, {}, feeds)


def test_print_passes_through_and_prints(capfd):
    rng = np.random.RandomState(8)
    x = _f32(rng, 2, 3)
    op_both("print", {"In": ["x"]}, {"Out": ["out"]},
            {"first_n": -1, "message": "hello", "summarize": 4}, {"x": x})
    lines = [ln for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("[print op]")]
    assert len(lines) == 2
    port = lines[-1]
    assert "hello" in port and "name=x" in port and "shape=(2, 3)" in port
    assert f"{float(x.ravel()[0])!r}"[:6] in port


@pytest.mark.parametrize("phase", ["both", "forward", "backward"])
def test_print_grad_maker(phase):
    """The Print layer's backward: a print of the gradient, or an assign
    under print_phase="forward", in both packages."""
    from torch_cross import build_both

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[3])
            h = fluid.layers.fc(x, 2)
            p = fluid.layers.Print(h, message="h", print_phase=phase)
            loss = fluid.layers.mean(p)
            fluid.backward.append_backward(loss)
        return main

    progs = build_both(build)
    kinds = [[(op.type, op.attrs.get("print_phase"))
              for op in progs[k].global_block().ops if op.type in
              ("print", "assign")] for k in ("ref", "port")]
    assert kinds[0] == kinds[1]
    assert len(kinds[1]) == 2
