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
