"""The port's memory-optimization transpiler
(paddle_tpu_torch/fluid/memory_optimization_transpiler.py) against the
reference's (paddle_tpu/fluid/memory_optimization_transpiler.py), the
counterparts of tests/test_memory_optimization.py and of
tests/test_program_verify.py's memory_optimize case, on the CPU.

Both passes rewrite a program built by either front end the same way: the
same renames and the same delete_var sites, op for op
(``tests/torch_cross.py::assert_same_program``). On the port's eager
Executor the rewritten program trains bitwise as the original does, and as
the reference's within float32 roundings."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import memory_optimization_transpiler as jmo
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import memory_optimization_transpiler as tmo

from torch_cross import assert_same_program, build_both, ref_state

PASSES = {"memory_optimize": (jmo.memory_optimize, tmo.memory_optimize),
          "release_memory": (jmo.release_memory, tmo.release_memory),
          "both": None}


def _build_mlp(fluid):
    """tests/test_memory_optimization.py's fc regression net with SGD."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16])
        y = fluid.layers.data("y", shape=[1])
        h = fluid.layers.fc(input=x, size=32, act="relu")
        h = fluid.layers.fc(input=h, size=32, act="relu")
        pred = fluid.layers.fc(input=h, size=1, act=None)
        cost = fluid.layers.square_error_cost(input=pred, label=y)
        avg = fluid.layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(avg, startup)
    return main, startup, avg


def _build_tower(fluid):
    """A shrinking fc tower: the 8-wide temporary dies before the 4-wide
    ones are defined, and must not be renamed onto (exact shapes only)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        a = fluid.layers.fc(input=x, size=8, act="relu")
        b = fluid.layers.fc(input=a, size=4, act="relu")
        c = fluid.layers.fc(input=b, size=4, act=None)
        c2 = fluid.layers.fc(input=c, size=4, act=None)
        out = fluid.layers.mean(c2)
    return main, startup, out


def _apply(which, program, fetch, ref):
    """Run ``which`` pass(es) of the reference (``ref``) or the port on
    ``program``; returns what each returned."""
    names = ["memory_optimize", "release_memory"] if which == "both" \
        else [which]
    return [PASSES[n][0 if ref else 1](program, fetch_list=[fetch])
            for n in names]


def _feed():
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 16).astype("float32")
    return {"x": xs, "y": (xs.sum(axis=1, keepdims=True) * 0.1)
            .astype("float32")}


def _train(main, startup, loss, steps=6, state=None):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.io.scope_from_numpy(state, "cpu") if state is not None \
        else tfluid.Scope()
    if state is None:
        exe.run(startup, scope=scope)
    return [float(exe.run(main, feed=_feed(), fetch_list=[loss.name],
                          scope=scope)[0]) for _ in range(steps)]


@pytest.mark.parametrize("which", list(PASSES))
@pytest.mark.parametrize("build", [_build_mlp, _build_tower],
                         ids=["mlp", "tower"])
def test_passes_rewrite_the_program_as_the_reference(which, build):
    """The same renames and delete_var sites as the reference's passes on
    the same program, and the same counts returned."""
    progs = build_both(build)
    got = _apply(which, progs["port"][0], progs["port"][2], ref=False)
    want = _apply(which, progs["ref"][0], progs["ref"][2], ref=True)
    assert got == want and all(n > 0 for n in got)
    assert_same_program(progs["port"][0], progs["ref"][0])


@pytest.mark.parametrize("which", list(PASSES))
def test_passes_keep_the_losses(which):
    """6 SGD steps: bitwise the unoptimized program's losses on the port's
    Executor, and the reference's within float32 roundings; the loss
    falls."""
    progs = build_both(_build_mlp)
    jmain, jstartup, jloss = progs["ref"]
    jexe, jscope, state = ref_state(jmain, jstartup, mode="eager")
    want = [float(np.asarray(jexe.run(jmain, feed=_feed(),
                                      fetch_list=[jloss.name],
                                      scope=jscope)[0]))
            for _ in range(6)]
    base = _train(*progs["port"], state=state)
    main, startup, loss = build_both(_build_mlp)["port"]
    _apply(which, main, loss, ref=False)
    got = _train(main, startup, loss, state=state)
    assert got == base
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_fewer_distinct_temporaries():
    main, _, avg = _build_mlp(tfluid)
    before = {n for op in main.global_block().ops
              for n in op.output_arg_names()}
    tfluid.memory_optimize(main, fetch_list=[avg])
    after = {n for op in main.global_block().ops
             for n in op.output_arg_names()}
    assert len(after) < len(before)


def test_deletes_land_at_death_points():
    """No op reads a deleted name after its delete_var (a later
    redefinition is legal)."""
    main, _, avg = _build_mlp(tfluid)
    assert tfluid.release_memory(main, fetch_list=[avg]) > 0
    ops = main.global_block().ops
    for i, op in enumerate(ops):
        if op.type != "delete_var":
            continue
        for name in op.input("X"):
            for later in ops[i + 1:]:
                if later.type == "delete_var":
                    continue
                if name in later.output_arg_names():
                    break
                assert name not in later.input_arg_names(), \
                    (name, later.type)


def test_fetch_is_protected():
    main, _, avg = _build_mlp(tfluid)
    tfluid.memory_optimize(main, fetch_list=[avg])
    tfluid.release_memory(main, fetch_list=[avg])
    ops = main.global_block().ops
    produced = {n for op in ops for n in op.output_arg_names()}
    deleted = {n for op in ops if op.type == "delete_var"
               for n in op.input("X")}
    assert avg.name in produced and avg.name not in deleted


def test_reuse_needs_the_exact_shape_at_every_level():
    """level=1 (the reference's size fit) still renames only onto an equal
    declared shape, so the tower's output is the unoptimized one."""
    x = np.random.RandomState(3).randn(5, 8).astype("float32")
    exe = tfluid.Executor(tfluid.CPUPlace())
    outs = []
    for level in (None, 1):
        tfluid.framework.reset_unique_name()
        main, startup, out = _build_tower(tfluid)
        if level is not None:
            assert tfluid.memory_optimize(main, fetch_list=[out],
                                          level=level) > 0
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        outs.append(exe.run(main, feed={"x": x}, fetch_list=[out.name],
                            scope=scope)[0])
    np.testing.assert_array_equal(outs[1], outs[0])


def test_control_flow_barrier_is_left_alone():
    """A program with a StaticRNN: the sub-block op's inputs are as they
    were, after both passes."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        h = tfluid.layers.fc(input=x, size=4, act="relu")
        seq = tfluid.layers.data("seq", shape=[3, 4])
        rnn = tfluid.layers.StaticRNN()
        with rnn.step():
            inp = rnn.step_input(seq)
            mem = rnn.memory(shape=[2, 4], value=0.0)
            nxt = tfluid.layers.fc(
                input=tfluid.layers.elementwise_add(inp, mem), size=4,
                act="tanh")
            rnn.update_memory(mem, nxt)
            rnn.step_output(nxt)
        out = tfluid.layers.elementwise_add(tfluid.layers.mean(rnn()),
                                            tfluid.layers.mean(h))

    def barrier_inputs():
        return [dict(op.inputs) for op in main.global_block().ops
                if any(op.has_attr(a) for a in ("sub_block",
                                                 "sub_block_false"))]
    before = barrier_inputs()
    assert before
    tfluid.memory_optimize(main, fetch_list=[out])
    tfluid.release_memory(main, fetch_list=[out])
    assert barrier_inputs() == before


def test_memory_optimized_program_verifies_clean():
    """tests/test_program_verify.py's case: both passes under
    verify_passes, then a clean verify with the fetch protected."""
    from paddle_tpu_torch.fluid.analysis import diagnostics as D
    from paddle_tpu_torch.testing.models import build_mlp
    main, _, loss = build_mlp(depth=2)
    tfluid.set_flags({"verify_passes": True})
    try:
        assert tfluid.memory_optimize(main, fetch_list=[loss.name]) > 0
        assert tfluid.release_memory(main, fetch_list=[loss.name]) > 0
    finally:
        tfluid.set_flags({"verify_passes": False})
    errors = [d for d in tfluid.verify_program(
        main, fetch_names=[loss.name], raise_on_error=False)
        if d.severity == D.ERROR]
    assert errors == []


def test_delete_var_spec_installs_39_of_39():
    """release_memory's delete_var ops are arity-checked: its slot spec is
    installed, so every spec of the catalogue is."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.fluid.analysis import slots
    installed = [t for t in slots._SPECS
                 if registry.get_op_info(t).slots is not None]
    assert len(installed) == len(slots._SPECS) == 39
    assert registry.get_op_info("delete_var").slots.inputs == {"X": "+"}
