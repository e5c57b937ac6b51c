"""The port's sparse-row gradients against the reference's.

``core/sparse.py`` (SparseRows, merge_rows, to_dense, apply_rowwise),
``lookup_table_grad`` with ``is_sparse`` on dense and LoD ids, ``sum`` over
SparseRows, and the sparse branches of sgd, momentum and adam, per
parameter and fused, each against ``paddle_tpu`` on the same numpy inputs;
then the port's counterparts of tests/test_sparse.py's training tests
(sparse equals dense on covered rows, lazy Adam, the LoD feed), each also
held to the reference's run of the same program.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import sparse as jsparse
from paddle_tpu_torch.core import sparse as tsparse

# training runs, losses and final state: float32 through an fc and the
# update, sums in another order between XLA and PyTorch (and XLA on the CPU
# may contract a multiply and an add into one fused multiply-add); a few
# float32 steps of the largest term
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _pair(rows, vals, nrows, merged=False):
    """The same SparseRows in both packages."""
    rows = np.asarray(rows)
    return (jsparse.SparseRows(jnp.asarray(rows, jnp.int32),
                               jnp.asarray(vals), nrows, merged),
            tsparse.SparseRows(torch.from_numpy(rows.astype("int64")),
                               torch.from_numpy(vals.copy()), nrows, merged))


CASES = {
    # duplicates, a sentinel (10) and an out-of-range sentinel (12)
    "duplicates_sentinels": ([3, 1, 3, 7, 1, 10, 3, 12], 10),
    "unique": ([4, 0, 9, 2], 10),
    "one_row": ([5, 5, 5, 5, 5], 6),
    "all_sentinels": ([6, 6, 6], 6),
    "empty": ([], 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_rows_and_to_dense_match_reference_bitwise(case):
    """Same rows, the same sums (from zero, in the entries' order within a
    run) and the same densified gradient, bit for bit."""
    rows, nrows = CASES[case]
    vals = np.random.RandomState(0).normal(
        0, 1, (len(rows), 3)).astype("float32")
    j, t = _pair(rows, vals, nrows)
    jm, tm = jsparse.merge_rows(j), tsparse.merge_rows(t)
    assert tm.merged and tm.nrows == nrows
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_array_equal(tm.values.numpy(), np.asarray(jm.values))
    for a, b in ((t, j), (tm, jm)):
        np.testing.assert_array_equal(a.to_dense().numpy(),
                                      np.asarray(b.to_dense()))
    assert tsparse.merge_rows(tm) is tm


def test_astype_keeps_rows_nrows_and_merged():
    _, t = _pair([2, 0], np.ones((2, 4), "float32"), 5, merged=True)
    h = t.astype(torch.float16)
    assert h.values.dtype == torch.float16 and h.dtype == torch.float16
    assert h.rows is t.rows and h.nrows == 5 and h.merged
    assert h.shape == (5, 4)
    assert tsparse.is_sparse(h) and not tsparse.is_sparse(h.values)


def test_apply_rowwise_matches_reference():
    """An Adam step over the touched rows (a duplicate and a sentinel):
    touched rows as the reference computes them, every other row and its
    state bitwise unchanged. Both evaluate the same float32 expression;
    XLA may fuse a multiply-add, so a float32 step or two apart."""
    lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
    rng = np.random.RandomState(3)
    w0 = rng.normal(size=(7, 2)).astype("float32")
    m0 = np.abs(rng.normal(size=(7, 2))).astype("float32")
    j, t = _pair([4, 1, 4, 7], rng.normal(size=(4, 2)).astype("float32"), 7)

    def adam_rows(xp):
        sqrt = jnp.sqrt if xp is jnp else torch.sqrt

        def upd(g, w, m1, m2):
            m1n = b1 * m1 + (1 - b1) * g
            m2n = b2 * m2 + (1 - b2) * g * g
            return w - lr * m1n / (sqrt(m2n) + eps), m1n, m2n
        return upd

    want = jsparse.apply_rowwise(
        j, [jnp.asarray(w0), jnp.asarray(m0), jnp.asarray(m0)],
        adam_rows(jnp))
    got = tsparse.apply_rowwise(
        t, [torch.from_numpy(w0), torch.from_numpy(m0),
            torch.from_numpy(m0)], adam_rows(torch))
    for g, w, before in zip(got, want, (w0, m0, m0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
        untouched = [0, 2, 3, 5, 6]
        np.testing.assert_array_equal(g.numpy()[untouched],
                                      before[untouched])


def _grad_program(fluid, lod, ops):
    """A program of grad ops over fed W, Ids and Out@GRAD variables; ``ops``
    is a list of (type, inputs, outputs, attrs)."""
    prog = fluid.Program()
    block = prog.global_block()
    block.create_var(name="w", shape=(9, 3), dtype="float32")
    for name, dtype, shape in (("ids", "int64", (-1, 1)),
                               ("ids2", "int64", (-1, 1)),
                               ("d", "float32", (-1, 3)),
                               ("d2", "float32", (-1, 3))):
        block.create_var(name=name, shape=shape, dtype=dtype,
                         lod_level=1 if lod else 0)
    for op in ops:
        for names in op[2].values():
            for n in names:
                block.create_var(name=n)
        block.append_op(*op)
    return prog


def _lookup_grad(ids, d, out, is_sparse):
    return ("lookup_table_grad", {"W": ["w"], "Ids": [ids],
                                  "Out@GRAD": [d]},
            {"W@GRAD": [out]}, {"is_sparse": is_sparse})


def _feeds(fluid, lod):
    rng = np.random.RandomState(4)
    w = rng.normal(size=(9, 3)).astype("float32")
    if not lod:
        return {"w": w,
                "ids": np.array([[3], [1], [3], [8], [0]], "int64"),
                "ids2": np.array([[1], [1], [5]], "int64"),
                "d": rng.normal(size=(5, 3)).astype("float32"),
                "d2": rng.normal(size=(3, 3)).astype("float32")}
    lens = (3, 1, 2)
    return {"w": w,
            "ids": [rng.randint(0, 9, (n, 1)).astype("int64") for n in lens],
            "ids2": [rng.randint(0, 9, (n, 1)).astype("int64")
                     for n in lens],
            "d": [rng.normal(size=(n, 3)).astype("float32") for n in lens],
            "d2": [rng.normal(size=(n, 3)).astype("float32") for n in lens]}


def _fetch(fluid, prog, lod, names):
    exe = fluid.Executor(fluid.CPUPlace())
    return exe.run(prog, feed=_feeds(fluid, lod), fetch_list=names,
                   scope=fluid.Scope(), return_numpy=False)


@pytest.mark.parametrize("lod", [False, True], ids=["dense", "lod"])
def test_lookup_table_grad_sparse_matches_reference(lod):
    """One entry per id, padded LoD positions sent to the sentinel row
    (9) with zeroed values: the reference's rows and values, bitwise."""
    ops = [_lookup_grad("ids", "d", "g", True)]
    want, = _fetch(jfluid, _grad_program(jfluid, lod, ops), lod, ["g"])
    got, = _fetch(tfluid, _grad_program(tfluid, lod, ops), lod, ["g"])
    assert tsparse.is_sparse(got) and got.nrows == 9 and not got.merged
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    if lod:
        assert (got.rows.numpy() == 9).sum() == 3  # 3 padded positions
    # its densified form is the dense gradient
    dense, = _fetch(tfluid, _grad_program(
        tfluid, lod, [_lookup_grad("ids", "d", "g", False)]), lod, ["g"])
    np.testing.assert_allclose(got.to_dense().numpy(), dense.numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mixed", [False, True], ids=["sparse", "mixed"])
def test_sum_over_sparse_rows_matches_reference(mixed):
    """All-sparse inputs concatenate their entries in input order; a dense
    input densifies the sparse ones."""
    ops = [_lookup_grad("ids", "d", "a", True),
           _lookup_grad("ids2", "d2", "b", not mixed),
           ("sum", {"X": ["a", "b"]}, {"Out": ["s"]}, {})]
    want, = _fetch(jfluid, _grad_program(jfluid, False, ops), False, ["s"])
    got, = _fetch(tfluid, _grad_program(tfluid, False, ops), False, ["s"])
    if mixed:
        assert torch.is_tensor(got)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
        return
    assert tsparse.is_sparse(got) and got.rows.shape == (8,)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))


OPTS = {
    "sgd": lambda fluid, fused: fluid.optimizer.SGD(
        learning_rate=0.1, fused=fused),
    "momentum": lambda fluid, fused: fluid.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, fused=fused),
    "adam": lambda fluid, fused: fluid.optimizer.Adam(
        learning_rate=0.05, fused=fused),
}


def _embedding_program(fluid, vocab, emb, opt, is_sparse, fused=False):
    """tests/test_sparse.py's program: embedding -> fc(4) -> mean square
    error (the embedding's [b, 1] ids already give [b, emb] rows, so the
    reference test's reshape is left out in both packages)."""
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        label = fluid.layers.data("y", shape=[4])
        e = fluid.layers.embedding(ids, size=[vocab, emb],
                                   is_sparse=is_sparse)
        pred = fluid.layers.fc(e, size=4, act=None)
        loss = fluid.layers.mean(
            fluid.layers.square(fluid.layers.elementwise_sub(pred, label)))
        OPTS[opt](fluid, fused).minimize(loss, startup)
    return main, startup, loss


def _state_names(main):
    return [v.name for v in main.global_block().vars.values()
            if v.persistable and not v.is_data]


def _train_both(build, feeds, ref_tier="jnp", port_tier="torch"):
    """Build with each front end, run the reference from its startup, the
    port from the reference's startup state; returns per package (losses,
    final state by name)."""
    jfluid.set_flags({"kernel_tier": ref_tier})
    tfluid.set_flags({"kernel_tier": port_tier})
    out = {}
    jmain, jstart, jloss = build(jfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = _state_names(jmain)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    tmain, _, tloss = build(tfluid)
    assert sorted(_state_names(tmain)) == sorted(names)
    tscope = tfluid.io.scope_from_numpy(init, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    for key, exe, main, loss, scope in (
            ("ref", jexe, jmain, jloss, jscope),
            ("port", texe, tmain, tloss, tscope)):
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0])) for f in feeds]
        out[key] = (losses, {n: np.array(scope.find_var(n))
                             for n in names})
    return init, out


def _feed_batches(vocab, n=4, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [{"ids": rng.randint(0, vocab, (batch, 1)).astype("int64"),
             "y": rng.normal(0, 1, (batch, 4)).astype("float32")}
            for _ in range(n)]


def _assert_same(out, tol=TOL):
    np.testing.assert_allclose(out["port"][0], out["ref"][0], **tol)
    for n, want in out["ref"][1].items():
        np.testing.assert_allclose(out["port"][1][n], want, **tol,
                                   err_msg=n)


@pytest.mark.parametrize("fused", [False, True], ids=["per_param", "fused"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_sparse_optimizer_branch_matches_reference(opt, fused):
    """Four steps on four batches (rows touched once, rows not touched,
    duplicates), losses and every parameter and accumulator against the
    reference's run of the same program."""
    _, out = _train_both(
        lambda fl: _embedding_program(fl, 12, 6, opt, True, fused),
        _feed_batches(12))
    _assert_same(out)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_sparse_matches_dense_when_rows_covered(opt):
    """tests/test_sparse.py:150 in the port: the same batch each step, so
    every touched row is touched every step and the lazy (sparse) and
    dense trajectories coincide; both also match the reference."""
    feeds = [_feed_batches(12, n=1)[0]] * 4
    runs = {}
    for is_sparse in (False, True):
        _, out = _train_both(
            lambda fl: _embedding_program(fl, 12, 6, opt, is_sparse),
            feeds)
        _assert_same(out)
        runs[is_sparse] = out["port"]
    np.testing.assert_allclose(runs[True][0], runs[False][0], **TOL)
    for n, dense in runs[False][1].items():
        np.testing.assert_allclose(runs[True][1][n], dense, **TOL,
                                   err_msg=n)
    assert runs[True][0][-1] < runs[True][0][0]


def test_sparse_adam_is_lazy():
    """tests/test_sparse.py:182 in the port: rows touched at step 1 but not
    at step 2 do not move at step 2 under sparse Adam, while dense Adam
    moves them through the decayed first moment."""
    feeds = [{"ids": np.array([[1], [2], [1], [3]], "int64"),
              "y": np.ones((4, 4), "float32")},
             {"ids": np.array([[4], [5], [4], [5]], "int64"),
              "y": np.ones((4, 4), "float32")}]
    tables = {}
    for is_sparse in (True, False):
        main, startup, loss = _embedding_program(tfluid, 10, 4, "adam",
                                                 is_sparse)
        w_name = main.global_block().ops[0].input("W")[0]
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        tables[is_sparse] = []
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            tables[is_sparse].append(scope.find_var(w_name).numpy().copy())
    (w1_s, w2_s), (w1_d, w2_d) = tables[True], tables[False]
    np.testing.assert_array_equal(w2_s[[1, 2, 3]], w1_s[[1, 2, 3]])
    assert np.abs(w2_s[[4, 5]] - w1_s[[4, 5]]).max() > 1e-6
    assert np.abs(w2_d[[1, 2, 3]] - w1_d[[1, 2, 3]]).max() > 1e-7
    # and the reference's lazy run, from the same startup state
    _, out = _train_both(
        lambda fl: _embedding_program(fl, 10, 4, "adam", True), feeds)
    _assert_same(out)


def _lod_program(fluid):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[1], dtype="int64",
                                lod_level=1)
        e = fluid.layers.embedding(src, size=[14, 6], is_sparse=True)
        h = fluid.layers.sequence_pool(e, pool_type="sum")
        pred = fluid.layers.fc(h, size=2, act=None)
        label = fluid.layers.data("y", shape=[2])
        loss = fluid.layers.mean(
            fluid.layers.square(fluid.layers.elementwise_sub(pred, label)))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
    return main, startup, loss


@pytest.mark.parametrize("routes", [("torch", "jnp"), ("cuda", "pallas")])
def test_sparse_embedding_with_lod_feed(routes):
    """tests/test_sparse.py:218 in the port: ragged ids from {0..5}; the
    padded positions go to the sentinel row, so rows 6.. never change
    (bitwise) while the touched rows move and the loss falls; the losses
    and the final state match the reference's."""
    rng = np.random.RandomState(5)
    seqs = [rng.randint(0, 6, (int(rng.randint(1, 5)), 1)).astype("int64")
            for _ in range(6)]
    feed = {"src": seqs, "y": rng.normal(0, 1, (6, 2)).astype("float32")}
    init, out = _train_both(_lod_program, [feed] * 3, routes[1], routes[0])
    _assert_same(out)
    w_name = [n for n in init if n.startswith("embedding")][0]
    w0, w1 = init[w_name], out["port"][1][w_name]
    losses = out["port"][0]
    assert losses[-1] < losses[0]
    np.testing.assert_array_equal(w1[6:], w0[6:])
    assert np.abs(w1[:6] - w0[:6]).max() > 1e-6
