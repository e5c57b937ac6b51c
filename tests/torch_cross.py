"""Helpers for the tests that hold a port program against the reference's:
build one program with each package's front end, give the port the
reference's startup state by name, run both on the same numpy feeds on the
CPU and compare."""

import numpy as np

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid


def build_both(build):
    """{"ref": build(jfluid), "port": build(tfluid)}, each from fresh
    unique names, so the two programs name their variables alike."""
    out = {}
    for key, fluid in (("ref", jfluid), ("port", tfluid)):
        fluid.framework.reset_unique_name()
        out[key] = build(fluid)
    return out


def ref_state(main, startup, mode="jit"):
    """The reference's executor and a scope holding its startup state, and
    that state as {name: np.ndarray} of every persistable the programs
    name."""
    exe = jfluid.Executor(jfluid.CPUPlace(), mode=mode)
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    names = {v.name for p in (main, startup)
             for v in p.global_block().vars.values()
             if v.persistable and not v.is_data}
    state = {n: np.array(scope.find_var(n)) for n in sorted(names)
             if scope.find_var(n) is not None}
    return exe, scope, state


def port_scope(state):
    """A port scope holding ``state`` on the CPU."""
    return tfluid.io.scope_from_numpy(state, "cpu")


def run_steps(exe, main, scope, feed, fetch, steps):
    """``steps`` runs of ``main`` on one feed; per step the fetches as
    numpy arrays (a LoD fetch as its flat data and offsets)."""
    out = []
    for _ in range(steps):
        vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        out.append([host(v) for v in vals])
    return out


def host(v):
    """A fetched value on the host: an array, or (flat, lod) of a LoD
    value of either package."""
    if hasattr(v, "lens"):
        if hasattr(v, "tree_flatten"):
            from paddle_tpu.core.lod import lodarray_to_flat
        else:
            from paddle_tpu_torch.core.lod import lodarray_to_flat
        flat, lod = lodarray_to_flat(v)
        return np.asarray(flat), lod
    return np.asarray(v)


def assert_close(got, want, rtol, atol=0.0, what=""):
    """Equal structure; LoD offsets equal; arrays within tolerance."""
    if isinstance(want, tuple):
        assert got[1] == want[1], (what, got[1], want[1])
        got, want = got[0], want[0]
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def cross_run(build, feed, fetch, steps=1, mode="jit"):
    """``build`` in both packages, the port from the reference's startup
    state, ``steps`` runs of each on ``feed``: (port fetches, reference
    fetches, the programs), fetches per step as ``run_steps`` gives
    them."""
    progs = build_both(build)
    jmain, jstartup = progs["ref"][:2]
    tmain = progs["port"][0]
    jexe, jscope, state = ref_state(jmain, jstartup, mode)
    want = run_steps(jexe, jmain, jscope, feed, fetch, steps)
    got = run_steps(tfluid.Executor(tfluid.CPUPlace()), tmain,
                    port_scope(state), feed, fetch, steps)
    return got, want, progs


# float32 op outputs: rtol 1e-5 and atol 1e-6 of the largest element (sums
# in another order); integer and bool outputs exactly
OP_RTOL, OP_ATOL_REL = 1e-5, 1e-6


def run_op(fluid, op_type, inputs, outputs, attrs, feeds, lod=()):
    """One op as a one-op program of ``fluid``'s package over ``feeds``
    (the reference's eager executor); the names in ``lod`` are fed as
    lists of sequences to lod_level-1 vars. Returns every output, in slot
    order, as ``host`` gives it."""
    prog = fluid.Program()
    block = prog.global_block()
    for name, arr in feeds.items():
        if name in lod:
            block.create_var(name=name, dtype=str(np.asarray(arr[0]).dtype),
                             lod_level=1)
        else:
            block.create_var(name=name, shape=np.shape(arr),
                             dtype=str(np.asarray(arr).dtype))
    fetch = [n for names in outputs.values() for n in names]
    for n in fetch:
        if not block.has_var(n):
            block.create_var(name=n)
    block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    exe = jfluid.Executor(jfluid.CPUPlace(), mode="eager") \
        if fluid is jfluid else fluid.Executor(fluid.CPUPlace())
    return [host(v) for v in exe.run(prog, feed=feeds, fetch_list=fetch,
                                     scope=fluid.Scope())]


def assert_op_close(got, want, what=""):
    """``got`` against ``want`` at the op tolerance: floats within rtol
    1e-5 / atol 1e-6 of want's largest element, anything else exact."""
    if isinstance(want, tuple):
        assert got[1] == want[1], (what, got[1], want[1])
        got, want = got[0], want[0]
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=OP_RTOL,
                                   atol=OP_ATOL_REL * scale, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def op_both(op_type, inputs, outputs, attrs, feeds, lod=()):
    """``run_op`` in both packages, every output held by
    ``assert_op_close``; returns the port's outputs."""
    want = run_op(jfluid, op_type, inputs, outputs, attrs, feeds, lod)
    got = run_op(tfluid, op_type, inputs, outputs, attrs, feeds, lod)
    names = [n for ns in outputs.values() for n in ns]
    for name, g, w in zip(names, got, want):
        assert_op_close(g, w, f"{op_type} {name}")
    return got
