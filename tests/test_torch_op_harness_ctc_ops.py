"""The reference's OpTest classes of tests/test_ctc_ops.py on the port: each
class's own data and test methods through tests/torch_op_test.py, every
check_output also held against the reference's executor
(torch_cross.port_optests says how)."""

from torch_cross import port_optests

PORTED = port_optests("test_ctc_ops", globals())


def test_warpctc_grad_is_scaled_on_the_port():
    """TestWarpCTCNormByTimes.test_grad_is_scaled with the port's fluid
    (the reference's method builds its programs with paddle_tpu.fluid, so
    it is on torch_cross.OPTEST_SKIPS): the analytic logits gradient with
    norm_by_times=True is the one without, over each sequence's frames."""
    import numpy as np
    import paddle_tpu_torch.fluid as fluid

    case = TestPortWarpCTCNormByTimes()
    case.setup_method(None)
    grads = {}
    for norm in (False, True):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            lg = fluid.layers.data("lg", shape=[4], lod_level=1)
            lb = fluid.layers.data("lb", shape=[1], dtype="int64",
                                   lod_level=1)
            loss = fluid.layers.warpctc(input=lg, label=lb, blank=0,
                                        norm_by_times=norm)
            fluid.backward.append_backward(fluid.layers.mean(loss))
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        grads[norm], = exe.run(
            main, feed={"lg": case.inputs["Logits"],
                        "lb": case.inputs["Label"]},
            fetch_list=["lg@GRAD"], return_numpy=False, scope=scope)
    g0 = grads[False].data.numpy()
    lens = grads[False].lens.numpy()
    np.testing.assert_allclose(grads[True].data.numpy(),
                               g0 / lens[:, None, None], atol=1e-6)
