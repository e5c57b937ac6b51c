"""CSP channels, Go and Select, the channel ops and the go op, and the
small fluid exports (counterpart of tests/test_concurrency.py and of
tests/test_fluid_surface.py's export and weight-norm cases).

The channel semantics are the reference's (framework/channel_impl.h): a
buffered channel drains in order after close and then reports not-ok, a
send on a closed channel raises, an unbuffered send completes only with a
receive. ``WeightNormParamAttr`` builds the reference's program op for op
and trains alike (losses within 1e-5 relative over 5 steps, the port from
the reference's startup state)."""

import time

import numpy as np
import pytest

from torch_cross import (assert_same_program, build_both, cross_losses,
                         jfluid, tfluid as fluid)


def test_buffered_channel_fifo_and_close_semantics():
    ch = fluid.make_channel("int32", capacity=4)
    for i in range(4):
        fluid.channel_send(ch, i)
    fluid.channel_close(ch)
    got = []
    while True:
        v, ok = fluid.channel_recv(ch)
        if not ok:
            break
        got.append(v)
    assert got == [0, 1, 2, 3]
    with pytest.raises(fluid.concurrency.ChannelClosed):
        fluid.channel_send(ch, 99)


def test_unbuffered_channel_rendezvous():
    ch = fluid.make_channel("float32", capacity=0)
    order = []
    with fluid.Go() as g:
        @g.run
        def producer():
            order.append("send-start")
            fluid.channel_send(ch, 1.0)
            order.append("send-done")

        time.sleep(0.2)
        assert "send-done" not in order
        v, ok = fluid.channel_recv(ch)
        assert ok and v == 1.0
        g.join(5.0)
    assert order == ["send-start", "send-done"]


def test_go_producer_feeds_training_through_channel():
    """A Go producer streams batches through a channel while the main
    thread trains (the reference's concurrency_test.cc pattern)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[6])
        y = layers.data("y", shape=[1])
        pred = layers.fc(x, size=1, act=None)
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    w_true = np.random.RandomState(0).normal(0, 1, (6, 1)).astype("float32")
    ch = fluid.make_channel("float32", capacity=2)
    with fluid.Go() as g:
        @g.run
        def producer():
            r = np.random.RandomState(1)
            for _ in range(30):
                xs = r.normal(0, 1, (32, 6)).astype("float32")
                fluid.channel_send(ch, (xs, xs @ w_true))
            fluid.channel_close(ch)

        losses = []
        while True:
            batch, ok = fluid.channel_recv(ch)
            if not ok:
                break
            losses.append(float(exe.run(main, feed={"x": batch[0],
                                                    "y": batch[1]},
                                        fetch_list=[loss], scope=scope)[0]))
        g.join(5.0)
    assert len(losses) == 30 and losses[-1] < 0.05 * losses[0]


def test_select_fibonacci():
    """A select alternating a send of the running term with a receive on
    the quit channel (the reference's CSP fibonacci)."""
    ch = fluid.make_channel("int64", capacity=1)
    quit_ch = fluid.make_channel("int64", capacity=1)
    result = []
    with fluid.Go() as g:
        @g.run
        def consumer():
            for _ in range(10):
                result.append(fluid.channel_recv(ch)[0])
            fluid.channel_send(quit_ch, 0)

        x, y, done = 0, 1, []
        while not done:
            sel = fluid.Select()

            @sel.case(fluid.channel_send, ch, x)
            def send_case():
                pass

            @sel.case(fluid.channel_recv, quit_ch)
            def quit_case(value, ok):
                done.append(True)

            if sel.run(timeout=10.0) == 0:
                x, y = y, x + y
        g.join(5.0)
    assert result == [0, 1, 1, 2, 3, 5, 8, 13, 21, 34]


def test_select_default_and_first_ready():
    a = fluid.make_channel("int64", capacity=1)
    b = fluid.make_channel("int64", capacity=1)
    got = []
    sel = fluid.Select()

    @sel.case(fluid.channel_recv, a)
    def case_a(value, ok):
        got.append(("a", value, ok))

    @sel.case(fluid.channel_recv, b)
    def case_b(value, ok):
        got.append(("b", value, ok))

    @sel.default
    def default_case():
        got.append(("default",))

    assert sel.run() == 2 and got == [("default",)]
    fluid.channel_send(b, 2)
    assert sel.run(timeout=1.0) == 1 and got[-1] == ("b", 2, True)
    fluid.channel_close(a)
    assert sel.run(timeout=1.0) == 0 and got[-1] == ("a", None, False)


def test_channel_ops_and_go_op_in_a_program():
    """channel_create keeps the channel in the scope (its variable
    persistable); a go op's sub-block sends on it from a thread, and
    channel_recv and channel_close run as ops of the main program."""
    prog = fluid.Program()
    block = prog.global_block()
    block.create_var(name="ch", persistable=True)
    for name in ("x", "out", "status", "thread"):
        block.create_var(name=name)
    block.append_op("channel_create", {}, {"Out": ["ch"]},
                    {"data_type": "float32", "capacity": 1})
    sub = prog.create_block()
    sub.append_op("channel_send", {"Channel": ["ch"], "X": ["x"]}, {}, {})
    prog.rollback()
    block.append_op("go", {"X": ["ch", "x"]}, {"Out": ["thread"]},
                    {"sub_block": sub.idx})
    block.append_op("channel_recv", {"Channel": ["ch"]},
                    {"Out": ["out"], "Status": ["status"]}, {})
    block.append_op("channel_close", {"Channel": ["ch"]}, {}, {})
    scope = fluid.Scope()
    x = np.arange(6, dtype="float32").reshape(2, 3)
    out, status = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={"x": x}, fetch_list=["out", "status"], scope=scope)
    np.testing.assert_array_equal(out, x)
    assert bool(status)
    ch = scope.find_var("ch")
    assert isinstance(ch, fluid.concurrency.Channel)
    assert ch.recv(timeout=1.0) == (None, False)


def test_flags_and_init_flags():
    from paddle_tpu_torch.core.flags import flags_version
    before, v0 = fluid.flags(), flags_version()
    rest = fluid.init_flags(["prog", "--check_nan_inf=true",
                             "--kernel_tier=torch", "--unknown=1", "pos"])
    try:
        assert rest == ["prog", "--unknown=1", "pos"]
        assert fluid.get_flag("check_nan_inf") is True
        assert fluid.flags()["kernel_tier"] == "torch"
        assert flags_version() == v0 + 2
    finally:
        fluid.set_flags({k: before[k] for k in ("check_nan_inf",
                                                "kernel_tier")})
    assert fluid.flags() == before
    assert set(before) <= set(jfluid.flags())


def test_the_small_exports():
    """The names the reference's fluid and fluid.layers export."""
    assert fluid.grad_var_name("w") == jfluid.grad_var_name("w") == "w@GRAD"
    assert fluid.LoDTensor is fluid.LoDArray
    assert fluid.executor.Executor is fluid.Executor
    for name in ("Constant", "Normal", "Xavier", "ParamAttr", "Variable",
                 "LayerHelper", "unique_name"):
        assert getattr(fluid.layers, name) is not None, name
    assert fluid.layers.Variable is fluid.Variable
    assert fluid.layers.ParamAttr is fluid.ParamAttr
    assert fluid.layers.monkey_patch_variable() is None
    public = {n for n in dir(jfluid) if not n.startswith("_")}
    assert public - set(dir(fluid)) == {"TPUPlace"}


def _weight_norm_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[6])
        y = fluid.layers.data("y", shape=[1])
        h = fluid.layers.fc(input=x, size=4, act="tanh",
                            param_attr=fluid.WeightNormParamAttr(
                                dim=1, name="wn"))
        pred = fluid.layers.fc(input=h, size=1, bias_attr=False,
                               param_attr=fluid.WeightNormParamAttr(
                                   name="wn_all"))
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
    return main, startup, loss


def test_weight_norm_param_attr():
    """v and g are the trainable parameters (g keep-dim shaped, set to
    ||v|| at startup), the program is the reference's, and it trains
    alike."""
    progs = build_both(_weight_norm_program)
    assert_same_program(progs["port"][0], progs["ref"][0])
    assert_same_program(progs["port"][1], progs["ref"][1])
    main, startup, _ = progs["port"]
    params = {p.name: p.shape for p in main.global_block().all_parameters()}
    assert params["wn.wn_v"] == (6, 4) and params["wn.wn_g"] == (1, 4)
    assert params["wn_all.wn_g"] == (1, 1) and "wn" not in params
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    v = scope.find_var("wn.wn_v").numpy()
    np.testing.assert_allclose(scope.find_var("wn.wn_g").numpy(),
                               np.sqrt((v ** 2).sum(axis=0, keepdims=True)),
                               rtol=1e-6)
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 6).astype("float32")
    feed = {"x": xs, "y": xs @ rng.randn(6, 1).astype("float32")}
    got, _ = cross_losses(progs, feed, steps=5)
    assert got[-1] < got[0]
