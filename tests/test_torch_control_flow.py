"""The port's control flow against the reference: StaticRNN, DynamicRNN,
While (with max_iters, with a derived bound, an underivable bound), the
carried-init gradient through one and two loops, a parameter staged
through a tensor array, IfElse, Switch and conditional_block.

Each case builds the same program with both packages (the counterparts of
tests/test_recurrent_grad.py and tests/test_misc_ops.py:325), gives the
port the reference's startup state, and holds the port's fetches and
gradients to the reference's on the same feed within CROSS_RTOL; the
training cases then train the port alone and hold it to the reference
test's own assertions.
"""

import numpy as np
import pytest

import paddle_tpu_torch.fluid as tfluid

from torch_cross import (assert_close, build_both, port_scope, ref_state,
                         run_steps)

# float32 loops: the two packages sum a matmul or a reduction in other
# orders and round tanh a float32 step apart; through a few steps of a
# loop that stays within 1e-5 relative (measured ≤ 3.4e-7 of the largest
# element on these cases), and an absolute floor of 1e-6 covers gradient
# elements near zero
CROSS_RTOL, CROSS_ATOL = 1e-5, 1e-6


def _static_rnn(fluid, batch=8, T=5, feat=6, hid=4):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[T, feat])
        y = layers.data("y", shape=[hid])
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[batch, hid], value=0.0)
            new_h = layers.fc(xt, size=hid, act="tanh",
                              param_attr=fluid.ParamAttr(name="rw"),
                              bias_attr=fluid.ParamAttr(name="rb"))
            h2 = layers.fc(h, size=hid, act=None, bias_attr=False,
                           param_attr=fluid.ParamAttr(name="hw"))
            nh = layers.tanh(layers.elementwise_add(new_h, h2))
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out = rnn()
        last = rnn.final_memory(h)
        loss = layers.mean(layers.square(layers.elementwise_sub(last, y)))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
    return main, startup, loss, out


def _static_rnn_feed(batch=8, T=5, feat=6, hid=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.normal(0, 1, (batch, T, feat)).astype("float32"),
            "y": rng.normal(0, 0.5, (batch, hid)).astype("float32")}


def _dynamic_rnn(fluid, vocab=12, emb=6, hid=5):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup):
        words = layers.data("words", shape=[1], dtype="int64", lod_level=1)
        label = layers.data("label", shape=[1])
        e = layers.embedding(words, size=[vocab, emb],
                             param_attr=fluid.ParamAttr(name="empar"))
        drnn = layers.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(e)
            h = drnn.memory(shape=[6, hid], value=0.0)
            nh = layers.fc(xt, size=hid, act="tanh",
                           param_attr=fluid.ParamAttr(name="dw"),
                           bias_attr=fluid.ParamAttr(name="db"))
            h2 = layers.fc(h, size=hid, act=None, bias_attr=False,
                           param_attr=fluid.ParamAttr(name="dh"))
            nh = layers.tanh(layers.elementwise_add(nh, h2))
            drnn.update_memory(h, nh)
            drnn.output(nh)
        hidden = drnn()
        pooled = layers.sequence_pool(hidden, pool_type="last")
        pred = layers.fc(pooled, size=1, act=None)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred,
                                                                label)))
        fluid.optimizer.Adam(learning_rate=0.02).minimize(loss, startup)
    return main, startup, loss, hidden


def _dynamic_rnn_feed(vocab=12):
    rng = np.random.RandomState(2)
    seqs = [rng.randint(0, vocab, (int(rng.randint(2, 6)), 1)).astype(
        "int64") for _ in range(6)]
    return {"words": seqs,
            "label": rng.normal(0, 1, (6, 1)).astype("float32")}


def _while_array(fluid, batch=6, T=4, feat=5, hid=3):
    """A While accumulation loop over fc of slices staged in an array."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[T, feat])
        y = layers.data("y", shape=[hid])
        pieces = layers.split(x, T, dim=1)
        arr = None
        for t in range(T):
            it = layers.fill_constant(shape=[1], dtype="int64", value=t)
            xt = layers.reshape(pieces[t], [batch, feat])
            arr = layers.array_write(xt, it, array=arr, cap=T)
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = layers.fill_constant(shape=[1], dtype="int64", value=T)
        acc = layers.fill_constant(shape=[batch, hid], dtype="float32",
                                   value=0.0)
        cond = layers.less_than(i, limit)
        w = layers.While(cond, max_iters=T)
        with w.block():
            xt = layers.array_read(arr, i)
            h = layers.fc(xt, size=hid, act="tanh",
                          param_attr=fluid.ParamAttr(name="ww"),
                          bias_attr=fluid.ParamAttr(name="wb"))
            layers.assign(layers.elementwise_add(acc, h), output=acc)
            layers.increment(i, value=1)
            layers.less_than(i, limit, cond=cond)
        loss = layers.mean(layers.square(layers.elementwise_sub(acc, y)))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss, startup)
    return main, startup, loss, acc


def _while_array_feed(batch=6, T=4, feat=5, hid=3):
    rng = np.random.RandomState(7)
    return {"x": rng.normal(0, 1, (batch, T, feat)).astype("float32"),
            "y": rng.normal(0, 1, (batch, hid)).astype("float32")}


def _while_derived(fluid, batch=4, T=3, hid=2):
    """The counter loop with no max_iters: while_grad derives the bound."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[3])
        y = layers.data("y", shape=[hid])
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = layers.fill_constant(shape=[1], dtype="int64", value=T)
        acc = layers.fill_constant(shape=[batch, hid], dtype="float32",
                                   value=0.0)
        cond = layers.less_than(i, limit)
        w = layers.While(cond)
        with w.block():
            h = layers.fc(x, size=hid, act="tanh",
                          param_attr=fluid.ParamAttr(name="dw"))
            layers.assign(layers.elementwise_add(acc, h), output=acc)
            layers.increment(i, value=1)
            layers.less_than(i, limit, cond=cond)
        loss = layers.mean(layers.square(layers.elementwise_sub(acc, y)))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss, startup)
    return main, startup, loss, acc


def _while_derived_feed(batch=4, hid=2):
    rng = np.random.RandomState(3)
    return {"x": rng.normal(0, 1, (batch, 3)).astype("float32"),
            "y": rng.normal(0, 1, (batch, hid)).astype("float32")}


def _carried_init(fluid, two_loops, batch=5, feat=4, hid=3, T=3):
    """The loop's carried init derives from the parameter W0: dL/dW0 goes
    through the pre-loop value."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[feat])
        y = layers.data("y", shape=[hid])
        h = layers.fc(x, size=hid, act=None,
                      param_attr=fluid.ParamAttr(name="W0"), bias_attr=False)

        def one_loop(h_var, wname):
            i = layers.fill_constant(shape=[1], dtype="int64", value=0)
            limit = layers.fill_constant(shape=[1], dtype="int64", value=T)
            cond = layers.less_than(i, limit)
            w = layers.While(cond, max_iters=T)
            with w.block():
                nh = layers.fc(h_var, size=hid, act="tanh",
                               param_attr=fluid.ParamAttr(name=wname),
                               bias_attr=False)
                layers.assign(nh, output=h_var)
                layers.increment(i, value=1)
                layers.less_than(i, limit, cond=cond)
            return h_var

        h = one_loop(h, "WL1")
        if two_loops:
            h = one_loop(h, "WL2")
        loss = layers.mean(layers.square(layers.elementwise_sub(h, y)))
        fluid.optimizer.SGD(learning_rate=0.0).minimize(loss, startup)
    return main, startup, loss, h


def _carried_feed(batch=5, feat=4, hid=3):
    rng = np.random.RandomState(3)
    return {"x": rng.normal(0, 1, (batch, feat)).astype("float32"),
            "y": rng.normal(0, 1, (batch, hid)).astype("float32")}


def _staged(fluid, batch=4, T=3, emb=5, hid=3):
    """An embedding consumed only through a tensor array read in a
    While."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.program_guard(main, startup):
        ids = layers.data("ids", shape=[T], dtype="int64")
        y = layers.data("y", shape=[hid])
        pieces = layers.split(ids, T, dim=1)
        arr = None
        for t in range(T):
            it = layers.fill_constant(shape=[1], dtype="int64", value=t)
            e = layers.embedding(pieces[t], size=[11, emb],
                                 param_attr=fluid.ParamAttr(
                                     name="staged_emb"))
            e = layers.reshape(e, [batch, emb])
            arr = layers.array_write(e, it, array=arr, cap=T)
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        limit = layers.fill_constant(shape=[1], dtype="int64", value=T)
        acc = layers.fill_constant(shape=[batch, hid], dtype="float32",
                                   value=0.0)
        cond = layers.less_than(i, limit)
        w = layers.While(cond, max_iters=T)
        with w.block():
            et = layers.array_read(arr, i)
            h = layers.fc(et, size=hid, act="tanh",
                          param_attr=fluid.ParamAttr(name="sw"),
                          bias_attr=False)
            layers.assign(layers.elementwise_add(acc, h), output=acc)
            layers.increment(i, value=1)
            layers.less_than(i, limit, cond=cond)
        loss = layers.mean(layers.square(layers.elementwise_sub(acc, y)))
        params_grads = fluid.optimizer.SGD(learning_rate=0.1).minimize(
            loss, startup)
    main._params = [p.name for p, _ in params_grads]
    return main, startup, loss, acc


def _staged_feed(batch=4, T=3, hid=3):
    rng = np.random.RandomState(9)
    return {"ids": rng.randint(0, 11, (batch, T)).astype("int64"),
            "y": rng.normal(0, 1, (batch, hid)).astype("float32")}


CASES = {
    "static_rnn": (_static_rnn, _static_rnn_feed,
                   ["rw", "rb", "hw"]),
    "dynamic_rnn": (_dynamic_rnn, _dynamic_rnn_feed,
                    ["empar", "dw", "db", "dh"]),
    "while_max_iters": (_while_array, _while_array_feed, ["ww", "wb"]),
    "while_derived_bound": (_while_derived, _while_derived_feed, ["dw"]),
    "carried_init_one_loop": (lambda f: _carried_init(f, False),
                              _carried_feed, ["W0", "WL1"]),
    "carried_init_two_loops": (lambda f: _carried_init(f, True),
                               _carried_feed, ["W0", "WL1", "WL2"]),
    "staged_through_array": (_staged, _staged_feed,
                             ["staged_emb", "sw"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_and_gradients_match_reference(case):
    """One step from the same state: the loss, the loop's output and every
    parameter's gradient, then two more steps' losses."""
    build, feed_fn, params = CASES[case]
    progs = build_both(build)
    jmain, jstartup, jloss, jout = progs["ref"]
    tmain, _, tloss, tout = progs["port"]
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    jexe, jscope, state = ref_state(jmain, jstartup)
    feed = feed_fn()
    fetch = [jloss.name, jout.name] + [p + "@GRAD" for p in params]
    want = run_steps(jexe, jmain, jscope, feed, fetch, 3)
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = run_steps(texe, tmain, port_scope(state), feed, fetch, 3)
    for step in range(3):
        for name, g, w in zip(fetch, got[step], want[step]):
            if step and name != jloss.name:
                continue
            assert_close(g, w, CROSS_RTOL, CROSS_ATOL,
                         f"{case} step {step + 1} {name}")


def _train(build, feed, steps):
    """The port trained ``steps`` steps on one feed from the reference's
    startup state (the reference test's model, init and feed)."""
    progs = build_both(build)
    jmain, jstartup = progs["ref"][:2]
    main, _, loss, _ = progs["port"]
    _, _, state = ref_state(jmain, jstartup)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = port_scope(state)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return main, scope, losses


@pytest.mark.parametrize("case,steps,ratio", [
    ("static_rnn", 60, 0.4), ("dynamic_rnn", 40, 0.2),
    ("while_max_iters", 50, 0.3), ("while_derived_bound", 40, 0.3),
    ("staged_through_array", 40, 0.3)])
def test_port_trains(case, steps, ratio):
    """The reference test's training assertions on the port."""
    build, feed_fn, params = CASES[case]
    main, _, losses = _train(build, feed_fn(), steps)
    assert losses[-1] < ratio * losses[0], losses[::10]
    if case == "static_rnn":
        milestones = losses[::12] + [losses[-1]]
        assert all(b < a for a, b in zip(milestones, milestones[1:]))
    if case == "while_derived_bound":
        grads = [op for op in main.global_block().ops
                 if op.type == "while_grad"]
        assert grads and int(grads[0].attrs["max_iters"]) == 3
    if case == "staged_through_array":
        assert "staged_emb" in main._params


def _loss_and_grads(main, startup, loss, feed, names, overrides=None):
    """(the loss, the grads of ``names``, the weights of ``names`` before
    the step) from the startup state with ``overrides`` set."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for name, value in (overrides or {}).items():
        scope.set(name, value)
    before = {n: scope.find_var(n).clone() for n in names}
    vals = exe.run(main, feed=feed,
                   fetch_list=[loss] + [n + "@GRAD" for n in names],
                   scope=scope)
    return float(vals[0]), [np.asarray(v) for v in vals[1:]], before


@pytest.mark.parametrize("case", ["static_rnn", "while_max_iters",
                                  "carried_init_one_loop",
                                  "carried_init_two_loops"])
def test_gradients_match_finite_differences(case):
    """The port's analytic gradients against central differences of its
    own forward (the reference test's rtol 5e-2, atol 1e-4). Each
    evaluation starts from the startup state with one weight moved; the
    fetched loss is the forward's, before the step's update."""
    build, feed_fn, params = CASES[case]
    tfluid.framework.reset_unique_name()
    main, startup, loss, _ = build(tfluid)
    feed = feed_fn()
    _, grads, base = _loss_and_grads(main, startup, loss, feed, params)
    eps = 1e-3
    for name, g in zip(params, grads):
        for idx in (0, g.size - 1):
            vals = []
            for sign in (1, -1):
                w = base[name].clone()
                w.view(-1)[idx] += sign * eps
                over = {n: v.clone() for n, v in base.items()}
                over[name] = w
                vals.append(_loss_and_grads(main, startup, loss, feed, [],
                                            over)[0])
            num = (vals[0] - vals[1]) / (2 * eps)
            np.testing.assert_allclose(g.flat[idx], num, rtol=5e-2,
                                       atol=1e-4, err_msg=str((name, idx)))


def test_static_rnn_stacked_output_metadata():
    _, _, _, out = _static_rnn(tfluid)
    assert out.dtype == "float32"
    assert tuple(out.shape[1:]) == (5, 4)


def test_while_underivable_bound_raises_on_backward():
    layers = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = layers.data("x", shape=[3])
        limit = layers.data("limit", shape=[1], dtype="int64",
                            append_batch_size=False)
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        acc = layers.fill_constant(shape=[4, 2], dtype="float32", value=0.0)
        cond = layers.less_than(i, limit)
        w = layers.While(cond)
        with w.block():
            h = layers.fc(x, size=2, act="tanh")
            layers.assign(layers.elementwise_add(acc, h), output=acc)
            layers.increment(i, value=1)
            layers.less_than(i, limit, cond=cond)
        loss = layers.mean(acc)
        with pytest.raises(RuntimeError, match="max_iters"):
            tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)


def test_while_max_iters_stops_a_true_condition():
    """max_iters is a visible semantic: a loop whose condition still holds
    stops after max_iters iterations, as the reference's masked scan."""
    def build(fluid):
        layers = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            i = layers.fill_constant(shape=[1], dtype="int64", value=0)
            limit = layers.fill_constant(shape=[1], dtype="int64", value=10)
            acc = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
            cond = layers.less_than(i, limit)
            w = layers.While(cond, max_iters=4)
            with w.block():
                layers.assign(layers.scale(acc, scale=2.0), output=acc)
                layers.increment(i, value=1)
                layers.less_than(i, limit, cond=cond)
        return main, startup, acc, i

    progs = build_both(build)
    jmain, jstartup, jacc, ji = progs["ref"]
    tmain, _, tacc, ti = progs["port"]
    jexe, jscope, state = ref_state(jmain, jstartup)
    want = run_steps(jexe, jmain, jscope, {}, [jacc.name, ji.name], 1)[0]
    got = run_steps(tfluid.Executor(tfluid.CPUPlace()), tmain,
                    port_scope(state), {}, [tacc.name, ti.name], 1)[0]
    assert float(got[0][0]) == float(want[0][0]) == 16.0
    assert int(got[1][0]) == int(want[1][0]) == 4


def _ifelse(fluid):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = layers.data("x", shape=[3])
        xv.stop_gradient = False
        cv = layers.data("c", shape=[1], dtype="bool")
        ie = layers.IfElse(cv)
        with ie.true_block():
            ie.output(layers.scale(ie.input(xv), scale=2.0))
        with ie.false_block():
            ie.output(layers.scale(ie.input(xv), scale=-1.0))
        merged, = ie()
        loss = layers.mean(merged)
        fluid.append_backward(loss)
    return main, startup, merged


def test_ifelse_select_and_grad():
    """tests/test_misc_ops.py:325 on both packages."""
    rng = np.random.RandomState(12)
    x = rng.normal(0, 1, (6, 3)).astype("float32")
    cond = (rng.rand(6, 1) > 0.5).astype("bool")
    progs = build_both(_ifelse)
    jmain, jstartup, jm = progs["ref"]
    tmain, _, tm = progs["port"]
    jexe, jscope, state = ref_state(jmain, jstartup)
    feed = {"x": x, "c": cond}
    fetch = [jm.name, "x@GRAD"]
    want = run_steps(jexe, jmain, jscope, feed, fetch, 1)[0]
    got = run_steps(tfluid.Executor(tfluid.CPUPlace()), tmain,
                    port_scope(state), feed, fetch, 1)[0]
    np.testing.assert_allclose(got[0], np.where(cond, 2.0 * x, -1.0 * x),
                               rtol=1e-6)
    np.testing.assert_allclose(got[1], np.where(cond, 2.0, -1.0) / x.size
                               * np.ones_like(x), rtol=1e-5)
    for g, w, n in zip(got, want, fetch):
        assert_close(g, w, CROSS_RTOL, CROSS_ATOL, n)


def _switch(fluid, use_default=True):
    """A Switch over a fed scalar: case x < 1 writes 10, case x < 2 writes
    20, default 30; the names stay bound before the switch."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[1], append_batch_size=False)
        one = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
        two = layers.fill_constant(shape=[1], dtype="float32", value=2.0)
        out = layers.fill_constant(shape=[1], dtype="float32", value=-1.0)
        sw = layers.Switch()
        with sw.case(layers.less_than(x, one)):
            layers.assign(layers.fill_constant(shape=[1], dtype="float32",
                                               value=10.0), output=out)
        with sw.case(layers.less_than(x, two)):
            layers.assign(layers.fill_constant(shape=[1], dtype="float32",
                                               value=20.0), output=out)
        if use_default:
            with sw.default():
                layers.assign(layers.fill_constant(
                    shape=[1], dtype="float32", value=30.0), output=out)
    return main, startup, out


@pytest.mark.parametrize("xval,use_default,want", [
    (0.5, True, 10.0), (1.5, True, 20.0), (2.5, True, 30.0),
    (2.5, False, -1.0)])
def test_switch_and_conditional_block(xval, use_default, want):
    """Switch (conditional_block over the chained conditions) takes the
    first case that holds; with no case taken and no default the bound
    value stays."""
    progs = build_both(lambda f: _switch(f, use_default))
    jmain, jstartup, jout = progs["ref"]
    tmain, _, tout = progs["port"]
    jexe, jscope, state = ref_state(jmain, jstartup)
    feed = {"x": np.array([xval], "float32")}
    w = run_steps(jexe, jmain, jscope, feed, [jout.name], 1)[0][0]
    g = run_steps(tfluid.Executor(tfluid.CPUPlace()), tmain,
                  port_scope(state), feed, [tout.name], 1)[0][0]
    assert float(g[0]) == float(w[0]) == want


def test_conditional_block_unbound_write_is_zeros():
    """A false conditional_block whose block writes a name bound nowhere
    else leaves zeros of the written shape (reference :420)."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            c = fluid.layers.data("c", shape=[1], dtype="bool",
                                  append_batch_size=False)
            block = main.global_block()
            out = block.create_var(name="cb_out", dtype="float32")
            sub = main.create_block()
            sub.append_op("fill_constant", outputs={"Out": ["cb_out"]},
                          attrs={"shape": [2, 3], "value": 7.0,
                                 "dtype": "float32"})
            main.rollback()
            block.append_op("conditional_block", inputs={"Cond": ["c"]},
                            outputs={}, attrs={"sub_block": sub.idx})
        return main, startup, out

    for flag, want in ((True, 7.0), (False, 0.0)):
        progs = build_both(build)
        jmain, jstartup, _ = progs["ref"]
        tmain, _, _ = progs["port"]
        jexe, jscope, state = ref_state(jmain, jstartup)
        feed = {"c": np.array([flag])}
        w = run_steps(jexe, jmain, jscope, feed, ["cb_out"], 1)[0][0]
        g = run_steps(tfluid.Executor(tfluid.CPUPlace()), tmain,
                      port_scope(state), feed, ["cb_out"], 1)[0][0]
        assert g.shape == w.shape == (2, 3)
        np.testing.assert_array_equal(g, np.full((2, 3), want, "float32"))
        np.testing.assert_array_equal(g, w)
