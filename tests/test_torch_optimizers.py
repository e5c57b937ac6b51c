"""The port's nine optimizers, weight decay and gradient clips against the
reference, one step at a time.

A small classifier (fc(8, relu) -> fc(3) -> mean(softmax_with_cross_
entropy) over 6 features, batch 5, inputs of scale 3 so that the clips
bite) is built by each package's front end with one optimizer, one
regularizer and one clip; the programs must have the same ops; the port
takes the reference's startup state by name, and one step on the same
numpy feed must give every parameter and accumulator within
‖Δ‖∞ ≤ 1e-5·‖ref‖∞. SGD, Momentum and Adam run fused under the port's
``cuda`` route (the arena wrappers' plain versions on the CPU), the other
six per parameter; the reference runs its ``jnp`` route.

Ftrl takes its class defaults (l1 = l2 = 0) in that grid: its l1 and l2
terms divide by |g|, so a float32 rounding of difference in a small
gradient (a sum whose terms cancel, summed in another order by each
package) moves the parameter by more than 1e-5 of the largest (1.0035e-5
at one element with l1 = l2 = 0.01, L2Decay and the value clip). Every
update op, those branches included, is also held to the reference's on
the same inputs, where no upstream rounding enters.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

# float32 through two small fcs and a softmax and back, the packages
# summing in other orders (XLA vs PyTorch's CPU kernels); the update
# expressions are the same operations in the same order. Held to 1e-5 of
# each state's largest element
STATE_REL = 1e-5

OPTIMIZERS = {
    "sgd": lambda o: o.SGD(0.1, fused=True),
    "momentum": lambda o: o.Momentum(0.1, 0.9, use_nesterov=True,
                                     fused=True),
    "adam": lambda o: o.Adam(0.01, fused=True),
    "adagrad": lambda o: o.Adagrad(0.1),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(0.1),
    "adadelta": lambda o: o.Adadelta(0.1),
    "rmsprop": lambda o: o.RMSProp(0.01, momentum=0.5),
    "adamax": lambda o: o.Adamax(0.01),
    "ftrl": lambda o: o.Ftrl(0.1),
}
DECAYS = {
    "none": lambda f: None,
    "l2": lambda f: f.regularizer.L2Decay(0.05),
    "l1": lambda f: f.regularizer.L1Decay(0.05),
}
CLIPS = {
    "none": lambda f: None,
    "value": lambda f: f.clip.GradientClipByValue(max=0.05),
    "norm": lambda f: f.clip.GradientClipByNorm(clip_norm=0.1),
    "global": lambda f: f.clip.GradientClipByGlobalNorm(clip_norm=0.1),
}


@pytest.fixture(autouse=True)
def _tiers():
    jfluid.set_flags({"kernel_tier": "jnp"})
    tfluid.set_flags({"kernel_tier": "cuda"})
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def build(fluid, opt, decay="none", clip="none"):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 8, act="relu")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, 3), label))
        c = CLIPS[clip](fluid)
        if c is not None:
            fluid.clip.set_gradient_clip(c)
        o = OPTIMIZERS[opt](fluid.optimizer)
        o.regularization = DECAYS[decay](fluid)
        o.minimize(loss, startup)
    return main, startup, loss


def feed():
    rng = np.random.RandomState(2)
    return {"x": rng.normal(0, 3, (5, 6)).astype("float32"),
            "label": rng.randint(0, 3, (5, 1)).astype("int64")}


def state_names(main):
    return [v.name for v in main.global_block().vars.values()
            if v.persistable and not v.is_data]


def reference_step(opt, decay="none", clip="none", steps=1):
    """(startup state, state after ``steps`` steps, the program)."""
    main, startup, loss = build(jfluid, opt, decay, clip)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = state_names(main)
    init = {n: np.array(scope.find_var(n)) for n in names}
    for _ in range(steps):
        exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    return init, {n: np.array(scope.find_var(n)) for n in names}, main


def port_step(opt, init, decay="none", clip="none", steps=1):
    main, _, loss = build(tfluid, opt, decay, clip)
    scope = tfluid.io.scope_from_numpy(init, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    for _ in range(steps):
        exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    return {n: scope.find_var(n).numpy() for n in init}, main


def assert_states_close(got, want):
    """Each state within STATE_REL of its largest element, NaN where the
    reference's is (Ftrl with l2 = 0 divides 0 by 0 at a gradient of
    exactly 0, as an L1 decay can cancel a clipped gradient to)."""
    for n, w in want.items():
        assert got[n].shape == w.shape, n
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(got[n]), nan, err_msg=n)
        w, g = w[~nan], got[n][~nan]
        rel = np.abs(g - w).max(initial=0) / max(np.abs(w).max(initial=0),
                                                 1e-30)
        assert rel <= STATE_REL, (n, rel)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_one_step_matches_reference(opt, decay, clip):
    init, want, jmain = reference_step(opt, decay, clip)
    got, tmain = port_step(opt, init, decay, clip)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert sorted(state_names(tmain)) == sorted(want)
    for n in want:   # the step moved every parameter
        if n.endswith(".w_0"):
            assert not np.array_equal(want[n], init[n]), n
    assert_states_close(got, want)


# (op type, state slots, attrs): each update op on the same numpy inputs
UPDATE_OPS = [
    ("adagrad", ["Moment"], {"epsilon": 1e-6}),
    ("decayed_adagrad", ["Moment"], {"decay": 0.8, "epsilon": 1e-6}),
    ("adadelta", ["AvgSquaredGrad", "AvgSquaredUpdate"],
     {"rho": 0.9, "epsilon": 1e-6}),
    ("rmsprop", ["MeanSquare", "Moment"],
     {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.5}),
    ("rmsprop", ["MeanSquare", "Moment"], {}),
    ("adamax", ["Moment", "InfNorm"],
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("ftrl", ["SquaredAccumulator", "LinearAccumulator"],
     {"l1": 0.01, "l2": 0.01, "lr_power": -0.5}),
    ("ftrl", ["SquaredAccumulator", "LinearAccumulator"],
     {"l1": 0.01, "l2": 0.02, "lr_power": -0.7}),
]
OUT_SLOT = {"Moment": "MomentOut", "AvgSquaredGrad": "AvgSquaredGradOut",
            "AvgSquaredUpdate": "AvgSquaredUpdateOut",
            "MeanSquare": "MeanSquareOut", "InfNorm": "InfNormOut",
            "SquaredAccumulator": "SquaredAccumOut",
            "LinearAccumulator": "LinearAccumOut"}


def run_update_op(fluid, op_type, slots, attrs, arrays):
    """One update op over fed arrays; returns its outputs by slot."""
    main = fluid.Program()
    block = main.global_block()
    inputs = {"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]}
    if op_type == "adamax":
        inputs["Beta1Pow"] = ["b1p"]
    inputs.update({s: [s.lower()] for s in slots})
    outputs = {"ParamOut": ["p_out"]}
    outputs.update({OUT_SLOT[s]: [s.lower() + "_out"] for s in slots})
    for names in list(inputs.values()) + list(outputs.values()):
        block.create_var(name=names[0], shape=arrays["p"].shape,
                         dtype="float32")
    block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    fetch = [n[0] for n in outputs.values()]
    exe = fluid.Executor(fluid.CPUPlace())
    feed = {k: v for k, v in arrays.items()
            if any(k == n[0] for n in inputs.values())}
    return dict(zip(outputs, exe.run(main, feed=feed, fetch_list=fetch,
                                     scope=fluid.Scope())))


@pytest.mark.parametrize("case", range(len(UPDATE_OPS)),
                         ids=[f"{t}-{i}" for i, (t, _, _) in
                              enumerate(UPDATE_OPS)])
def test_update_op_matches_reference(case):
    """Each of the six new update ops, and Ftrl's two branches with l1 and
    l2 set, on the same inputs (small gradients among them): the same
    float32 expressions, so within a few roundings, held to 1e-6 of each
    output's largest element (an element-wise bound fails on Ftrl's power
    branch, where XLA's and PyTorch's pow differ by a rounding and sigma
    divides the difference of two of them by lr: 3.2e-6 of one element
    of LinearAccumOut, 1e-7 of the largest)."""
    op_type, slots, attrs = UPDATE_OPS[case]
    rng = np.random.RandomState(case)
    g = rng.normal(0, 1, (6, 5)).astype("float32")
    g[0] *= 1e-3
    arrays = {"p": rng.normal(0, 1, (6, 5)).astype("float32"), "g": g,
              "lr": np.array([0.05], "float32"),
              "b1p": np.array([0.9 ** 3], "float32")}
    for s in slots:
        arrays[s.lower()] = np.abs(rng.normal(0, 1, (6, 5))).astype(
            "float32") if s != "LinearAccumulator" else \
            rng.normal(0, 1, (6, 5)).astype("float32")
    want = run_update_op(jfluid, op_type, slots, attrs, arrays)
    got = run_update_op(tfluid, op_type, slots, attrs, arrays)
    for slot, w in want.items():
        w = np.asarray(w)
        assert np.abs(got[slot] - w).max() <= 1e-6 * np.abs(w).max(), slot


def test_param_regularizer_wins_over_the_optimizers():
    """A ParamAttr regularizer is the one applied to its parameter (the
    reference's rule): the decay term reads only that coefficient."""
    def build_one(fluid):
        fluid.framework.reset_unique_name()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[6])
            h = fluid.layers.fc(x, 3, param_attr=fluid.ParamAttr(
                name="w", regularizer=fluid.regularizer.L1Decay(0.5)))
            loss = fluid.layers.mean(h)
            fluid.optimizer.SGD(0.1, regularization=fluid.regularizer
                                .L2Decay(0.01)).minimize(loss, startup)
        return main

    for fluid in (jfluid, tfluid):
        ops = build_one(fluid).global_block().ops
        sign, = [op for op in ops if op.type == "sign"]
        assert sign.input("X") == ["w"]
        coeffs = sorted(op.attr("scale") for op in ops
                        if op.type == "scale")
        assert coeffs == [0.01, 0.5]


def test_optimizer_names_and_accumulators_match_reference():
    """Every optimizer of the reference exists in the port under its name
    and alias, with the same accumulators."""
    for name in ("SGD", "Momentum", "Adam", "Adagrad", "DecayedAdagrad",
                 "Adadelta", "RMSProp", "Adamax", "Ftrl"):
        assert getattr(tfluid.optimizer, name) is \
            getattr(tfluid.optimizer, name + "Optimizer")
    for opt in ("adagrad", "decayed_adagrad", "adadelta", "rmsprop",
                "adamax", "ftrl"):
        jmain = build(jfluid, opt)[0]
        tmain = build(tfluid, opt)[0]
        assert sorted(tmain.global_block().vars) == \
            sorted(jmain.global_block().vars)
