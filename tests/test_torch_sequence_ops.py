"""The port's sequence ops and multi-level LoD against the reference, on
the same numpy inputs, forward and gradient: every sequence_pool type
(with stride windows and pooling to a sequence over nested LoD),
sequence_softmax, sequence_expand (innermost, ragged x, ref_level 0 over
2- and 3-level LoD), sequence_concat, sequence_reshape, sequence_slice,
sequence_erase, lod_reset, sequence_conv, row_conv, max_sequence_len;
2- and 3-level feed and fetch through the executor (nested lists with an
empty outer group, the flat wire form); the LoD beam_search cases of
tests/test_multilevel_lod.py:310 and :329 and beam_search_decode's 2-level
output (:98). The counterparts of tests/test_sequence_ops.py and
tests/test_multilevel_lod.py.

A case's program is built by each package's front end: the op over data
vars (stop_gradient off), loss = mean(square(out)) and append_backward;
the outputs and the inputs' gradients are compared. The reference runs
eagerly (``mode="eager"``): its jit form pads a data-dependent output
(sequence_expand of a ragged x) to a static bound the eager form does
not.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import lod as jlod
from paddle_tpu_torch.core import lod as tlod

from torch_cross import assert_close, build_both, cross_run, host, \
    port_scope, ref_state

# float32 elementwise, masked sums and small matmuls: the packages may sum
# in other orders, a few float32 roundings apart (measured ≤ 6.7e-7 of
# the largest element on these cases, the recurrences' three steps
# included; the pooling, expansion, slicing and beam cases are exact)
RTOL, ATOL = 1e-5, 1e-6

OFFS = [0, 4, 5, 8]                      # tests/test_sequence_ops.py _lod


def _flat(dim=3, seed=3, n=8):
    return np.random.RandomState(seed).uniform(0.1, 1, (n, dim)).astype(
        "float32")


def _seqs(flat, offs=OFFS):
    return [flat[a:b] for a, b in zip(offs[:-1], offs[1:])]


def _op_program(fluid, op_type, inputs, outputs, attrs, loss_out=None,
                grads=()):
    """``inputs``: slot -> [(name, shape, dtype, lod_level)]; ``outputs``:
    slot -> [name] (each declared with lod_level 1 unless it is the
    loss). With ``loss_out`` the program adds loss = mean(square(out)) and
    its backward; the vars in ``grads`` take gradients."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        block = main.global_block()
        for slot, specs in inputs.items():
            for name, shape, dtype, lod_level in specs:
                v = fluid.layers.data(name, shape=list(shape), dtype=dtype,
                                      lod_level=lod_level,
                                      append_batch_size=lod_level > 0)
                v.stop_gradient = name not in grads
        for slot, names in outputs.items():
            for n in names:
                block.create_var(name=n, dtype="float32", lod_level=1)
        block.append_op(op_type,
                        inputs={s: [x[0] for x in v]
                                for s, v in inputs.items()},
                        outputs=outputs, attrs=attrs)
        if loss_out is not None:
            out = block.var(loss_out)
            loss = fluid.layers.mean(fluid.layers.square(out))
            fluid.append_backward(loss)
    return main, startup


def _check(op_type, inputs, feed, outputs, attrs, grads=(), loss_out=None,
           rtol=RTOL, atol=ATOL):
    """Run the op's program in both packages on ``feed``; compare every
    output and the gradients of ``grads``."""
    progs = build_both(lambda f: _op_program(
        f, op_type, inputs, outputs, attrs, loss_out, grads))
    jmain, jstartup = progs["ref"]
    tmain, _ = progs["port"]
    jexe, jscope, state = ref_state(jmain, jstartup, mode="eager")
    fetch = [n for ns in outputs.values() for n in ns] \
        + [g + "@GRAD" for g in grads]
    want = [host(v) for v in jexe.run(jmain, feed=_copy(feed),
                                      fetch_list=fetch, scope=jscope)]
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [host(v) for v in texe.run(tmain, feed=_copy(feed),
                                     fetch_list=fetch,
                                     scope=port_scope(state))]
    for name, g, w in zip(fetch, got, want):
        assert_close(g, w, rtol, atol, f"{op_type} {name}")
    return got


def _copy(feed):
    import copy
    return copy.deepcopy(feed)


POOLTYPES = ["AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST"]


@pytest.mark.parametrize("pooltype", POOLTYPES)
def test_sequence_pool(pooltype):
    x = _flat()
    if pooltype == "MAX":
        # distinct values: the max's subgradient is one element
        x = (np.random.RandomState(13).permutation(x.size).astype("float32")
             * 0.05).reshape(x.shape)
    got = _check("sequence_pool", {"X": [("x", (3,), "float32", 1)]},
                 {"x": _seqs(x)}, {"Out": ["out"]},
                 {"pooltype": pooltype}, grads=["x"], loss_out="out")
    ref = {"AVERAGE": np.mean, "SUM": np.sum, "MAX": np.max,
           "SQRT": lambda s, axis: s.sum(axis) / np.sqrt(len(s)),
           "LAST": lambda s, axis: s[-1], "FIRST": lambda s, axis: s[0]}
    want = np.stack([ref[pooltype](s, axis=0) for s in _seqs(x)])
    np.testing.assert_allclose(got[0], want, rtol=1e-6)


@pytest.mark.parametrize("pooltype", ["SUM", "MAX", "LAST", "FIRST",
                                      "AVERAGE", "SQRT"])
def test_sequence_pool_stride_windows(pooltype):
    seqs = [np.arange(7, dtype="float32").reshape(7, 1) + 1,
            np.arange(4, dtype="float32").reshape(4, 1) + 10]
    got = _check("sequence_pool", {"X": [("x", (1,), "float32", 1)]},
                 {"x": seqs}, {"Out": ["out"]},
                 {"pooltype": pooltype, "stride": 3})
    assert got[0][1] == [[0, 3, 5]]


def test_sequence_pool_to_sequence_over_nested():
    flat = np.arange(14, dtype="float32").reshape(7, 2)
    lod = [[0, 2, 3], [0, 2, 5, 7]]
    got = _check("sequence_pool", {"X": [("x", (2,), "float32", 2)]},
                 {"x": (flat, lod)}, {"Out": ["out"]},
                 {"pooltype": "SUM", "agg_level": "seq"})
    np.testing.assert_allclose(got[0][0], np.stack(
        [flat[0:2].sum(0), flat[2:5].sum(0), flat[5:7].sum(0)]))
    assert got[0][1] == [[0, 2, 3]]


def test_sequence_softmax():
    x = _flat(dim=1)
    _check("sequence_softmax", {"X": [("x", (1,), "float32", 1)]},
           {"x": _seqs(x)}, {"Out": ["out"]}, {}, grads=["x"],
           loss_out="out")


def test_sequence_expand_dense_x():
    x = _flat(dim=2, n=3)
    y = [np.zeros((n, 1), "float32") for n in (2, 3, 1)]
    _check("sequence_expand", {"X": [("x", (2,), "float32", 0)],
                               "Y": [("y", (1,), "float32", 1)]},
           {"x": x, "y": y}, {"Out": ["out"]}, {}, grads=["x"],
           loss_out="out")


def test_sequence_expand_ragged_x():
    x = _seqs(_flat(dim=2, n=5), [0, 2, 5])
    y = [np.zeros((n, 1), "float32") for n in (3, 2)]
    _check("sequence_expand", {"X": [("x", (2,), "float32", 1)],
                               "Y": [("y", (1,), "float32", 1)]},
           {"x": x, "y": y}, {"Out": ["out"]}, {}, grads=["x"],
           loss_out="out")


@pytest.mark.parametrize("levels", [2, 3])
def test_sequence_expand_ref_level0(levels):
    x = np.array([[1.0, 10.0], [2.0, 20.0]], "float32")
    z = [np.zeros((n, 1), "float32") for n in range(1, 6)]
    y = [[z[1], z[0]], [z[2], z[1], z[0]]] if levels == 2 else \
        [[[z[0]], [z[0], z[0]]], [[z[0], z[0]]]]
    got = _check("sequence_expand", {"X": [("x", (2,), "float32", 0)],
                                     "Y": [("y", (1,), "float32", levels)]},
                 {"x": x, "y": y}, {"Out": ["out"]}, {"ref_level": 0},
                 grads=["x"], loss_out="out")
    rows = [0, 0, 1, 1, 1] if levels == 2 else [0, 0, 0, 1, 1]
    np.testing.assert_allclose(got[0], x[rows])


def test_sequence_concat():
    a = _seqs(_flat(dim=2, n=6, seed=1), [0, 2, 6])
    b = _seqs(_flat(dim=2, n=4, seed=2), [0, 3, 4])
    _check("sequence_concat", {"X": [("a", (2,), "float32", 1),
                                     ("b", (2,), "float32", 1)]},
           {"a": a, "b": b}, {"Out": ["out"]}, {}, grads=["a", "b"],
           loss_out="out")


def test_sequence_reshape():
    x = _seqs(_flat(dim=4, n=6), [0, 2, 6])
    _check("sequence_reshape", {"X": [("x", (4,), "float32", 1)]},
           {"x": x}, {"Out": ["out"]}, {"new_dim": 2}, grads=["x"],
           loss_out="out")


def test_sequence_slice():
    x = _seqs(_flat(dim=2), OFFS)
    _check("sequence_slice", {"X": [("x", (2,), "float32", 1)],
                              "Offset": [("off", (3, 1), "int64", 0)],
                              "Length": [("len", (3, 1), "int64", 0)]},
           {"x": x, "off": np.array([[1], [0], [1]], "int64"),
            "len": np.array([[2], [1], [2]], "int64")},
           {"Out": ["out"]}, {}, grads=["x"], loss_out="out")


def test_sequence_erase():
    seqs = [np.array([[2], [1], [6], [1], [0]], "int64"),
            np.array([[1], [1]], "int64"), np.array([[3], [4]], "int64")]
    got = _check("sequence_erase", {"X": [("x", (1,), "int64", 1)]},
                 {"x": seqs}, {"Out": ["out"]}, {"tokens": [1, 6]})
    np.testing.assert_array_equal(got[0][0].reshape(-1), [2, 0, 3, 4])
    assert got[0][1] == [[0, 2, 2, 4]]


@pytest.mark.parametrize("form", ["target_lod", "y_lod", "y_offsets"])
def test_lod_reset(form):
    x = _seqs(_flat(dim=2), OFFS)
    inputs = {"X": [("x", (2,), "float32", 1)]}
    feed = {"x": x}
    attrs = {}
    if form == "target_lod":
        attrs["target_lod"] = [0, 2, 6, 8]
    elif form == "y_lod":
        inputs["Y"] = [("y", (1,), "float32", 1)]
        feed["y"] = [np.zeros((n, 1), "float32") for n in (3, 3, 2)]
    else:
        inputs["Y"] = [("y", (4,), "int32", 0)]
        feed["y"] = np.array([0, 1, 7, 8], "int32")
    got = _check("lod_reset", inputs, feed, {"Out": ["out"]}, attrs)
    np.testing.assert_allclose(got[0][0], np.concatenate(x))


@pytest.mark.parametrize("context", [(3, -1), (3, 0), (2, -1)])
def test_sequence_conv(context):
    length, start = context
    x = _seqs(_flat(dim=3), OFFS)
    filt = np.random.RandomState(4).normal(0, 1, (3 * length, 5)).astype(
        "float32")
    _check("sequence_conv", {"X": [("x", (3,), "float32", 1)],
                             "Filter": [("f", filt.shape, "float32", 0)]},
           {"x": x, "f": filt}, {"Out": ["out"]},
           {"contextLength": length, "contextStart": start},
           grads=["x", "f"], loss_out="out")


def test_row_conv():
    x = _seqs(_flat(dim=3), OFFS)
    filt = np.random.RandomState(5).normal(0, 1, (3, 3)).astype("float32")
    _check("row_conv", {"X": [("x", (3,), "float32", 1)],
                        "Filter": [("f", filt.shape, "float32", 0)]},
           {"x": x, "f": filt}, {"Out": ["out"]}, {}, grads=["x", "f"],
           loss_out="out")


def test_max_sequence_len():
    seqs = [np.zeros((n, 1), "float32") for n in (3, 7, 2)]
    got = _check("max_sequence_len",
                 {"RankTable": [("x", (1,), "float32", 1)]}, {"x": seqs},
                 {"Out": ["out"]}, {})
    assert int(got[0][0]) == 7


def test_edit_distance_ignored_tokens():
    """edit_distance(ignored_tokens=...) erases the tokens from both
    sides first (sequence_erase)."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            h = fluid.layers.data("h", shape=[1], dtype="int64", lod_level=1)
            r = fluid.layers.data("r", shape=[1], dtype="int64", lod_level=1)
            d, _ = fluid.layers.edit_distance(h, r, ignored_tokens=[0])
        return main, startup, d

    progs = build_both(build)
    jmain, jstartup, jd = progs["ref"]
    tmain, _, _ = progs["port"]
    feed = {"h": [np.array([[1], [0], [2]], "int64"),
                  np.array([[3], [0]], "int64")],
            "r": [np.array([[1], [2]], "int64"),
                  np.array([[0], [4], [3]], "int64")]}
    jexe, jscope, state = ref_state(jmain, jstartup, mode="eager")
    want = jexe.run(jmain, feed=_copy(feed), fetch_list=[jd.name],
                    scope=jscope)[0]
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=_copy(feed), fetch_list=[jd.name],
        scope=port_scope(state))[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want))
    np.testing.assert_allclose(np.asarray(got).reshape(-1), [0.0, 1.0])


# ---------------------------------------------------------------------------
# multi-level LoD (tests/test_multilevel_lod.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lod", [
    [[0, 2, 3], [0, 2, 5, 7]],
    [[0, 2, 3], [0, 2, 4, 5], [0, 2, 4, 7, 9, 11]]])
def test_flat_roundtrip_matches_reference(lod):
    n = lod[-1][-1]
    flat = np.arange(2 * n, dtype="float32").reshape(n, 2)
    j = jlod.flat_to_lodarray(flat, lod)
    t = tlod.flat_to_lodarray(flat, lod)
    assert t.lod_level == j.lod_level == len(lod)
    np.testing.assert_array_equal(t.lens.numpy(), np.asarray(j.lens))
    for a, b in zip(t.outer_levels, j.outer_levels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back, lod2 = tlod.lodarray_to_flat(t)
    np.testing.assert_array_equal(back, flat)
    assert lod2 == lod
    for level in range(len(lod) - 1):
        np.testing.assert_array_equal(t.row_to_outer(level).numpy(),
                                      np.asarray(j.row_to_outer(level)))


def _scale_program(fluid, lod_level, dtype="float32"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[1], dtype=dtype,
                              lod_level=lod_level)
        out = fluid.layers.scale(x, scale=2.0)
    return main, startup, out


def _z(*vals):
    return np.array(vals, "float32").reshape(-1, 1)


@pytest.mark.parametrize("name,lod_level,feed", [
    ("2-level nested", 2, [[_z(1, 2), _z(3, 4, 5)], [_z(6, 7)]]),
    ("2-level flat", 2, (_z(1, 2, 3, 4, 5, 6, 7), [[0, 2, 3],
                                                   [0, 2, 5, 7]])),
    ("2-level empty outer group", 2, [[], [_z(1, 2), _z(3)]]),
    ("3-level nested", 3, [[[_z(1, 2), _z(3)], [_z(4, 5)]], [[_z(6)]]]),
])
def test_feed_fetch_nested_lod(name, lod_level, feed):
    """Feed and fetch through both executors: the same values and the
    same offsets at every level."""
    progs = build_both(lambda f: _scale_program(f, lod_level))
    jmain, jstartup, jout = progs["ref"]
    tmain, _, tout = progs["port"]
    jexe, jscope, state = ref_state(jmain, jstartup)
    want = host(jexe.run(jmain, feed={"x": _copy(feed)},
                         fetch_list=[jout.name], scope=jscope)[0])
    got = host(tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={"x": _copy(feed)}, fetch_list=[tout.name],
        scope=port_scope(state))[0])
    assert len(got[1]) == lod_level, name
    assert_close(got, want, 0, 0, name)
    if name == "2-level empty outer group":
        assert got[1][0] == [0, 0, 2]


def _lod_beam(fluid, beam, end_id):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        b = main.global_block()
        for n in ("ids", "scores", "sel_ids", "sel_scores"):
            b.create_var(name=n, lod_level=2)
        b.create_var(name="pre_ids", shape=[-1, 1], dtype="int64",
                     is_data=True)
        b.append_op("beam_search",
                    {"pre_ids": ["pre_ids"], "ids": ["ids"],
                     "scores": ["scores"]},
                    {"selected_ids": ["sel_ids"],
                     "selected_scores": ["sel_scores"]},
                    {"beam_size": beam, "end_id": end_id, "level": 0})
    return main, startup


@pytest.mark.parametrize("case", ["reference_case", "finished_prefix"])
def test_beam_search_lod(case):
    """beam_search_op_test.cc's case (2 sources with [1, 3] prefixes, K 3,
    beam 2) and a finished prefix leaving the beam, in both packages."""
    if case == "reference_case":
        ids = np.array([[4, 2, 5], [2, 1, 3], [3, 5, 2], [8, 2, 1]], "int64")
        scores = np.array([[0.5, 0.3, 0.2], [0.6, 0.3, 0.1],
                           [0.9, 0.5, 0.1], [0.7, 0.5, 0.1]], "float32")
        outer, pre, beam, end = [1, 3], [1, 2, 3, 4], 2, 0
        want_flat, want_lod = [2, 4, 3, 8], [[0, 1, 4], [0, 2, 2, 3, 4]]
    else:
        ids = np.array([[4, 2], [9, 7]], "int64")
        scores = np.array([[0.9, 0.8], [0.95, 0.7]], "float32")
        outer, pre, beam, end = [2], [1, 0], 3, 0
        want_flat, want_lod = [2, 4], [[0, 2], [0, 2, 2]]
    k = ids.shape[1]
    pre_ids = np.array(pre, "int64").reshape(-1, 1)
    progs = build_both(lambda f: _lod_beam(f, beam, end))
    got = {}
    for key, fluid, mod, as_t in (
            ("ref", jfluid, jlod, np.asarray),
            ("port", tfluid, tlod, torch.from_numpy)):
        main, _ = progs[key]
        scope = fluid.Scope()
        for n, v in (("ids", ids), ("scores", scores)):
            scope.set(n, mod.LoDArray(as_t(v[:, :, None]),
                                      as_t(np.full(len(v), k, "int32")),
                                      as_t(np.array(outer, "int32"))))
        exe = fluid.Executor(fluid.CPUPlace(), mode="eager") \
            if key == "ref" else fluid.Executor(fluid.CPUPlace())
        kw = {"use_program_cache": False} if key == "ref" else {}
        got[key] = [host(v) for v in exe.run(
            main, feed={"pre_ids": pre_ids},
            fetch_list=["sel_ids", "sel_scores"], scope=scope, **kw)]
    for g, w in zip(got["port"], got["ref"]):
        assert_close(g, w, 0, 0, case)
    np.testing.assert_array_equal(got["port"][0][0].reshape(-1), want_flat)
    assert got["port"][0][1] == got["port"][1][1] == want_lod


def _decode_program(fluid, beam, cap):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids_arr = fluid.layers.create_array("int32", cap=cap)
        par_arr = fluid.layers.create_array("int32", cap=cap)
        sc = fluid.layers.data("sc", shape=[beam])
        sent_ids, sent_scores = fluid.layers.beam_search_decode(
            ids_arr, par_arr, sc, end_id=1)
    return main, startup, ids_arr, par_arr, sent_ids, sent_scores


@pytest.mark.parametrize("length", [4, 3])
def test_beam_search_decode_2level_lod(length):
    """tests/test_multilevel_lod.py:98, with parents that move between
    beams and end tokens, in both packages: level 0 groups the beam rows of
    each source, level 1 each row's tokens up to its first end."""
    from paddle_tpu.ops.control_flow_ops import TensorArrayVal as JArr
    from paddle_tpu_torch.ops.control_flow_ops import TensorArrayVal as TArr

    b, beam, T = 2, 3, 4
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 9, (T, b, beam)).astype("int32")
    parents = rng.randint(0, beam, (T, b, beam)).astype("int32")
    scores = rng.rand(b, beam).astype("float32")
    progs = build_both(lambda f: _decode_program(f, beam, T))
    import jax.numpy as jnp
    got = {}
    for key, fluid, arr_t, as_t in (
            ("ref", jfluid, JArr, jnp.asarray),
            ("port", tfluid, TArr, torch.from_numpy)):
        main, _, ia, pa, si, ss = progs[key]
        scope = fluid.Scope()
        n = np.asarray(length, "int32")
        scope.set(ia.name, arr_t(as_t(ids), as_t(n)))
        scope.set(pa.name, arr_t(as_t(parents), as_t(n)))
        exe = fluid.Executor(fluid.CPUPlace(), mode="eager") \
            if key == "ref" else fluid.Executor(fluid.CPUPlace())
        got[key] = [host(v) for v in exe.run(
            main, feed={"sc": scores}, fetch_list=[si.name, ss.name],
            scope=scope)]
    for g, w in zip(got["port"], got["ref"]):
        assert_close(g, w, 0, 0, f"length {length}")
    lod = got["port"][0][1]
    assert len(lod) == 2 and lod[0] == [0, beam, 2 * beam]


# ---------------------------------------------------------------------------
# the unit RNN ops and the other recurrences (tests/test_rnn_ops.py)
# ---------------------------------------------------------------------------

def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).normal(0, 1, shape) * scale).astype(
        "float32")


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit(forget_bias):
    b, H = 4, 5
    _check("lstm_unit", {"X": [("x", (b, 4 * H), "float32", 0)],
                         "C_prev": [("c", (b, H), "float32", 0)]},
           {"x": _rand(b, 4 * H, seed=1), "c": _rand(b, H, seed=2)},
           {"C": ["c_out"], "H": ["h_out"]}, {"forget_bias": forget_bias},
           grads=["x", "c"], loss_out="h_out")


@pytest.mark.parametrize("bias", [True, False])
def test_gru_unit(bias):
    b, H = 4, 5
    inputs = {"Input": [("x", (b, 3 * H), "float32", 0)],
              "HiddenPrev": [("h", (b, H), "float32", 0)],
              "Weight": [("w", (H, 3 * H), "float32", 0)]}
    feed = {"x": _rand(b, 3 * H, seed=1), "h": _rand(b, H, seed=2),
            "w": _rand(H, 3 * H, seed=3, scale=0.3)}
    grads = ["x", "h", "w"]
    if bias:
        inputs["Bias"] = [("bias", (1, 3 * H), "float32", 0)]
        feed["bias"] = _rand(1, 3 * H, seed=4)
        grads.append("bias")
    _check("gru_unit", inputs, feed,
           {"Gate": ["gate"], "ResetHiddenPrev": ["rhp"],
            "Hidden": ["hidden"]},
           {"activation": "tanh", "gate_activation": "sigmoid"},
           grads=grads, loss_out="hidden")


def _ragged_ids(seed, n=6, vocab=10):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(0, vocab, (int(rng.randint(2, 6)), 1)).astype(
        "int64") for _ in range(n)]
    return {"x": seqs, "y": rng.normal(0, 1, (n, 1)).astype("float32")}


def _lstmp_model(fluid, H=12, P=5):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[1], dtype="int64", lod_level=1)
        e = layers.embedding(x, size=[10, 8])
        proj, cell = layers.dynamic_lstmp(layers.fc(e, size=4 * H),
                                          size=4 * H, proj_size=P)
        pred = layers.fc(layers.sequence_last_step(proj), size=1)
        y = layers.data("y", shape=[1])
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        fluid.optimizer.Adam(learning_rate=0.03).minimize(loss, startup)
    return main, startup, loss, [proj.name, cell.name]


def _peephole_model(fluid, peep):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[1], dtype="int64", lod_level=1)
        e = layers.embedding(x, size=[10, 8])
        h, c = layers.dynamic_lstm(layers.fc(e, size=32), size=32,
                                   use_peepholes=peep)
        pred = layers.fc(layers.sequence_last_step(h), size=1)
        y = layers.data("y", shape=[1])
        loss = layers.mean(layers.square(layers.elementwise_sub(pred, y)))
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss, startup)
    return main, startup, loss, [h.name, c.name]


MODELS = {"lstmp": (_lstmp_model, 1, 40, 0.2),
          "peepholes": (lambda f: _peephole_model(f, True), 0, 40, 0.25)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_recurrent_models_match_reference_and_train(model):
    """dynamic_lstmp (tests/test_rnn_ops.py:184) and the peephole LSTM
    (:219): 3 steps from the reference's state hold the losses, the
    outputs and every parameter's gradient to the reference's; then the
    port trains on to the reference test's ratio."""
    build, seed, steps, ratio = MODELS[model]
    feed = _ragged_ids(seed)
    tfluid.framework.reset_unique_name()
    probe, _, loss, outs = build(tfluid)
    fetch = [loss.name] + outs + [p.name + "@GRAD"
                                  for p in probe.all_parameters()]
    peep_bias = [p.name for p in probe.all_parameters()
                 if p.shape and p.shape[-1] == 7 * 8]
    got, want, progs = cross_run(build, feed, fetch, 3)
    for step in range(3):
        for name, g, w in zip(fetch, got[step], want[step]):
            if step and name != fetch[0]:
                continue
            assert_close(g, w, 1e-5, 1e-6, f"{model} step {step + 1} "
                                           f"{name}")
    exe = tfluid.Executor(tfluid.CPUPlace())

    def train(progs):
        _, _, state = ref_state(*progs["ref"][:2])
        scope = port_scope(state)
        return scope, [float(exe.run(progs["port"][0], feed=feed,
                                     fetch_list=[progs["port"][2]],
                                     scope=scope)[0])
                       for _ in range(steps)]

    scope, losses = train(progs)
    assert losses[-1] < ratio * losses[0], losses[::10]
    if model == "lstmp":
        proj, cell = exe.run(progs["port"][0], feed=feed,
                             fetch_list=fetch[1:3], scope=scope)
        assert proj.data.shape[-1] == 5 and cell.data.shape[-1] == 12
    else:
        # the diagonal peephole weights trained away from zero, and the
        # trajectory differs from the plain LSTM's
        b = scope.find_var(peep_bias[0]).numpy()
        assert np.abs(b[0, 32:]).max() > 1e-4
        _, plain = train(build_both(lambda f: _peephole_model(f, False)))
        assert not np.allclose(losses[5:], plain[5:], rtol=1e-4)


def _vanilla(fluid, bias):
    H = 4
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[H], lod_level=1)
        battr = fluid.ParamAttr(name="rb") if bias else False
        out = fluid.layers.dynamic_vanilla_rnn(
            x, size=H, act="tanh", param_attr=fluid.ParamAttr(name="rw"),
            bias_attr=battr)
        rev = fluid.layers.dynamic_vanilla_rnn(
            x, size=H, act="tanh", is_reverse=True,
            param_attr=fluid.ParamAttr(name="rw"), bias_attr=battr)
        loss = fluid.layers.mean(fluid.layers.sequence_pool(
            fluid.layers.elementwise_add(out, rev), "sum"))
        fluid.append_backward(loss)
    return main, startup, loss, out, rev


@pytest.mark.parametrize("bias", [True, False])
def test_simple_rnn(bias):
    """dynamic_vanilla_rnn forward and reversed over ragged lengths against
    a numpy recurrence and the reference, and its grads (shape (H, H) and,
    with a bias, (1, H)) against the reference's (tests/test_rnn_ops.py
    :272, :326)."""
    rng = np.random.RandomState(0)
    seqs = [rng.normal(0, 1, (n, 4)).astype("float32") for n in (5, 3, 4)]
    grads = ["rw@GRAD"] + (["rb@GRAD"] if bias else [])
    tfluid.framework.reset_unique_name()
    _, _, loss, out, rev = _vanilla(tfluid, bias)
    fetch = [loss.name, out.name, rev.name] + grads
    got, want, progs = cross_run(lambda f: _vanilla(f, bias)[:2],
                                 {"x": seqs}, fetch, 1)
    for name, g, w in zip(fetch, got[0], want[0]):
        assert_close(g, w, 1e-5, 1e-6, name)
    main = progs["port"][0]
    assert len(main.all_parameters()) == (2 if bias else 1)
    _, _, state = ref_state(*progs["ref"][:2])
    w, b = state["rw"], state.get("rb", np.zeros((1, 4), "float32"))

    def ref_run(seq):
        h, outs = np.zeros(4, "float32"), []
        for t in range(len(seq)):
            h = np.tanh(seq[t] + b.reshape(-1) + h @ w)
            outs.append(h)
        return np.stack(outs)

    np.testing.assert_allclose(got[0][1][0], np.concatenate(
        [ref_run(s) for s in seqs]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0][2][0], np.concatenate(
        [ref_run(s[::-1])[::-1] for s in seqs]), rtol=1e-5, atol=1e-6)
    assert got[0][3].shape == (4, 4) and np.abs(got[0][3]).sum() > 0
    if bias:
        assert got[0][4].shape == (1, 4)
