"""The port's training slice as a whole against the reference.

A narrow ResNet (stage depths 1,1,1,1, base width 8, 32x32 images, 10
classes, batch 4) with mean(softmax_with_cross_entropy), fuse_conv_bn and
Momentum(0.1, 0.9, fused=True) is built by each package's front end. The
programs must have the same ops; the port takes the reference's startup
state by name, and 3 steps on one feed must give the same losses, step-1
gradients and final parameters. The port runs under kernel_tier=cuda, so
every supported chain goes through the kernel wrappers (their plain versions
on the CPU) and the 4 unsupported ones are counted fallbacks in each
direction.
"""

import collections

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.testing.models import resnet

BATCH, STEPS = 4, 3
# float32 through 17 conv+BN layers and back: the packages sum convs and
# batch statistics in other orders (XLA vs oneDNN and PyTorch's reductions).
# Losses: measured within 2.2e-6 relative over the 3 steps.
TOL = dict(rtol=1e-4, atol=1e-5)
# Step-1 gradients, each held as max|Δ| / max|ref| (a gradient's small
# entries would fail any per-element relative bound): measured within 1.7e-5.
GRAD_REL = 1e-4
# Parameters and velocities after 3 steps at lr 0.1, the same measure: the
# step-1 differences grow through the later steps, as batch norm amplifies
# them layer by layer, to 1.1e-3 on the worst velocity
STATE_REL = 3e-3


@pytest.fixture(autouse=True)
def _fresh():
    tfluid.set_flags({"kernel_tier": "auto"})
    yield
    tfluid.set_flags({"kernel_tier": "auto"})
    jfluid.set_flags({"kernel_tier": "auto"})


def _build(fluid):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[32, 32, 3])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet(img, 10, counts=(1, 1, 1, 1), base=8,
                        layers=fluid.layers)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        assert fluid.fuse_conv_bn(main) == 17
        fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 fused=True).minimize(loss, startup)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(3)
    return {"img": rng.normal(0, 1, (BATCH, 32, 32, 3)).astype("float32"),
            "label": rng.randint(0, 10, (BATCH, 1)).astype("int64")}


@pytest.fixture(scope="module")
def reference_run():
    """The reference's 3 steps: (main, startup state, losses, step-1
    grads, final state)."""
    jfluid.set_flags({"kernel_tier": "jnp"})
    main, startup, loss = _build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    state = [v.name for v in main.global_block().vars.values()
             if v.persistable and not v.is_data]
    init = {n: np.array(scope.find_var(n)) for n in state}
    grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()
             if p.trainable]
    feed = _feed()
    losses, step1 = [], None
    for step in range(STEPS):
        out = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                      scope=scope)
        losses.append(float(np.asarray(out[0])))
        if step == 0:
            step1 = [np.asarray(g) for g in out[1:]]
    final = {n: np.array(scope.find_var(n)) for n in state}
    jfluid.set_flags({"kernel_tier": "auto"})
    return main, init, losses, dict(zip(grads, step1)), final


def test_programs_have_the_same_ops(reference_run):
    jmain = reference_run[0]
    tmain, tstart, _ = _build(tfluid)
    t_ops = [op.type for op in tmain.global_block().ops]
    j_ops = [op.type for op in jmain.global_block().ops]
    assert collections.Counter(t_ops) == collections.Counter(j_ops)
    assert t_ops == j_ops
    assert sorted(tmain.global_block().vars) == \
        sorted(jmain.global_block().vars)


def test_training_steps_match_reference(reference_run):
    _, init, want_losses, want_grads, want_final = reference_run
    tfluid.set_flags({"kernel_tier": "cuda"})
    main, _, loss = _build(tfluid)
    scope = tfluid.io.scope_from_numpy(init, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = _feed()
    grads = list(want_grads)
    losses = []
    for step in range(STEPS):
        ttier.reset_fallback_counts()
        out = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                      scope=scope)
        assert ttier.fallback_counts() == {"conv_bn": 4 * 2}
        losses.append(float(out[0]))
        if step == 0:
            for name, g in zip(grads, out[1:]):
                want = want_grads[name]
                assert g.shape == want.shape, name
                rel = np.abs(g - want).max() / np.abs(want).max()
                assert rel <= GRAD_REL, (name, rel)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    assert losses[-1] < losses[0]
    for name, want in want_final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert rel <= STATE_REL, (name, rel)


def test_fused_and_per_parameter_momentum_agree_bitwise():
    """Under kernel_tier=torch the fused_momentum program equals the
    per-parameter momentum program bitwise (the reference's pin in
    tests/test_fused_optimizer.py, re-pinned in the port)."""
    def run(fused):
        tfluid.reset_unique_name()
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 2
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[6])
            label = tfluid.layers.data("label", shape=[1], dtype="int64")
            loss = tfluid.layers.mean(tfluid.layers.softmax_with_cross_entropy(
                tfluid.layers.fc(tfluid.layers.fc(x, 8, act="relu"), 3),
                label))
            tfluid.optimizer.Momentum(0.1, 0.9, use_nesterov=True,
                                      fused=fused).minimize(loss, startup)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        feed = {"x": rng.normal(0, 1, (5, 6)).astype("float32"),
                "label": rng.randint(0, 3, (5, 1)).astype("int64")}
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        return {n: scope.find_var(n).numpy() for n in scope.local_names()
                if isinstance(scope.find_var(n), torch.Tensor)}

    tfluid.set_flags({"kernel_tier": "torch"})
    per_param, fused = run(False), run(True)
    assert sorted(per_param) == sorted(fused)
    for name in per_param:
        np.testing.assert_array_equal(fused[name], per_param[name],
                                      err_msg=name)


@pytest.mark.parametrize("case", ["all", "parameter_list", "no_grad_set",
                                  "stop_gradient"])
def test_append_backward_matches_reference(case):
    """append_backward appends the reference's grad ops, in its order, and
    returns the same (param, grad) pairs, whichever way the gradient set is
    narrowed."""
    def build(fluid):
        fluid.framework.reset_unique_name()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[6])
            label = fluid.layers.data("label", shape=[1], dtype="int64")
            h = fluid.layers.fc(x, 8, act="relu")
            if case == "stop_gradient":
                h.stop_gradient = True
            z = fluid.layers.elementwise_add(fluid.layers.fc(h, 3),
                                             fluid.layers.fc(x, 3))
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(z, label))
            kw = {}
            if case == "parameter_list":
                kw["parameter_list"] = ["fc_1.w_0", "fc_2.w_1"]
            if case == "no_grad_set":
                kw["no_grad_set"] = {h.name}
            pairs = fluid.append_backward(loss, **kw)
        return main, [(p.name, g.name) for p, g in pairs]

    jmain, jpairs = build(jfluid)
    tmain, tpairs = build(tfluid)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert [(op.inputs, op.outputs) for op in tmain.global_block().ops] == \
        [(op.inputs, op.outputs) for op in jmain.global_block().ops]
    assert tpairs == jpairs and tpairs


def test_backward_raises_for_an_op_without_grad_maker():
    """append_backward refuses a path through an op with no grad maker
    rather than silently dropping the parameters behind it."""
    tfluid.reset_unique_name()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        h = tfluid.layers.fc(x, 3)
        scaled = main.global_block().create_var(name="scaled", shape=h.shape,
                                                dtype="float32")
        # sign (the L1 decay's) registers no grad maker
        main.global_block().append_op("sign", inputs={"X": [h.name]},
                                      outputs={"Out": ["scaled"]})
        loss = tfluid.layers.mean(scaled)
        with pytest.raises(RuntimeError, match="no grad"):
            tfluid.append_backward(loss)


def _build_recipe(fluid):
    """The narrow net with the training recipe's knobs: Momentum with
    L2Decay, every parameter carrying a GradientClipByGlobalNorm as its
    gradient_clip (what ParamAttr(gradient_clip=...) sets; the model
    helper resnet() takes no ParamAttr), and a piecewise schedule."""
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[32, 32, 3])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        logits = resnet(img, 10, counts=(1, 1, 1, 1), base=8,
                        layers=fluid.layers)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        assert fluid.fuse_conv_bn(main) == 17
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm=1.0))
        lr = fluid.layers.piecewise_decay(boundaries=[2], values=[0.1, 0.01])
        fluid.optimizer.Momentum(
            learning_rate=lr, momentum=0.9, fused=True,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(
                loss, startup)
    return main, startup, loss


def test_decay_clip_and_schedule_train_the_narrow_resnet():
    """Momentum(fused=True) with L2Decay, a global-norm clip and a
    piecewise schedule: the programs have the same ops; under the port's
    cuda route one step gives each velocity (v1 = f·g + 1e-4·p0, f the
    clip's factor) and each parameter within GRAD_REL of the reference's
    largest element (measured: 1.6e-5 and 1.2e-5; the clip shrinks the
    step to a few float32 roundings of p, so p1 − p0 is no measure); the
    loss falls over 3 steps."""
    jfluid.set_flags({"kernel_tier": "jnp"})
    jmain, jstart, jloss = _build_recipe(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(jstart, scope=scope)
    state = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and not v.is_data]
    init = {n: np.array(scope.find_var(n)) for n in state}
    exe.run(jmain, feed=_feed(), fetch_list=[jloss], scope=scope)
    want = {n: np.array(scope.find_var(n)) for n in state}

    tfluid.set_flags({"kernel_tier": "cuda"})
    tmain, _, tloss = _build_recipe(tfluid)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    tscope = tfluid.io.scope_from_numpy(init, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    losses = [float(texe.run(tmain, feed=_feed(), fetch_list=[tloss],
                             scope=tscope)[0])]
    update, = [op for op in tmain.global_block().ops
               if op.type == "fused_momentum"]
    for names in (update.input("Velocities"), update.input("Params")):
        for name in names:
            got, ref = tscope.find_var(name).numpy(), want[name]
            rel = np.abs(got - ref).max() / np.abs(ref).max()
            assert rel <= GRAD_REL, (name, rel)
    for _ in range(2):
        losses.append(float(texe.run(tmain, feed=_feed(),
                                     fetch_list=[tloss], scope=tscope)[0]))
    assert losses[-1] < losses[0]
