"""The port's sparse SGD kernels' modules against the reference's.

``ops/cuda/embedding.py``: ``embedding_sgd`` takes the unmerged entries
and fuses the merge; on CPU tensors it runs its plain version,
``embedding_sgd_torch`` (merge_rows, then the row update). Both are held
to the reference's ``embedding_sgd_pallas`` (interpret mode) fed the
reference's merge, and to its scatter twin ``embedding_sgd_jnp``, in the
counterparts of tests/test_fused_embedding_sgd.py; ``embedding_sgd_scatter``
(the plain op chain's unmerged scatter) to ``embedding_sgd_jnp``.
``ops/cuda/optimizer.py``: ``sgd_arena`` (its plain version on the CPU)
against ``sgd_arena_pallas``. Then the sgd op's routing: the kernel
route's wrapper calls, a bfloat16 table's counted fallback, and the
end-to-end is_sparse training program in both pairings. The kernels
themselves are held bitwise to their plain versions where a card is
present (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.sparse import SparseRows as JSparseRows, merge_rows
from paddle_tpu.ops.pallas import optimizer as jax_opk
from paddle_tpu.ops.pallas.embedding import (embedding_sgd_jnp,
                                             embedding_sgd_pallas)
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops import optimizer_ops
from paddle_tpu_torch.ops.cuda import embedding as embk
from paddle_tpu_torch.ops.cuda import optimizer as opk

# against the Pallas kernel on the reference's merged rows: the same sums
# (the merges agree bitwise, tests/test_torch_sparse.py) and the same
# w − lr·s; XLA on the CPU may fuse the multiply and the subtract into one
# multiply-add, which rounds once instead of twice: a float32 step of w
PALLAS_TOL = dict(rtol=2e-7, atol=1e-7)
# against the scatter twin on duplicates: it adds −lr·v of each entry to the
# row one at a time, the kernel subtracts lr times their sum, so a row moves
# by other roundings, one float32 step of w per entry (the reference test's
# own tolerance)
SCATTER_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _reset():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})
    ttier.reset_fallback_counts()


def _table(rng, v=12, d=6):
    return rng.normal(0, 1, (v, d)).astype("float32")


def _port(w, rows, vals, lr):
    """The plain version and the wrapper on CPU tensors (tensor lr), both
    as numpy, and the wrapper launches nothing."""
    t = (torch.from_numpy(w.copy()), torch.tensor(rows, dtype=torch.int64),
         torch.from_numpy(vals.copy()))
    before = embk.launches["embedding_sgd"]
    outs = [embk.embedding_sgd_torch(*t, lr).numpy(),
            embk.embedding_sgd(*t, torch.tensor(lr)).numpy()]
    assert embk.launches["embedding_sgd"] == before
    np.testing.assert_array_equal(t[0].numpy(), w)  # the CPU path is pure
    return outs


def _pallas_merged(w, rows, vals, lr, nrows):
    m = merge_rows(JSparseRows(jnp.asarray(rows, jnp.int32),
                               jnp.asarray(vals), nrows))
    return np.asarray(embedding_sgd_pallas(jnp.asarray(w), m.rows, m.values,
                                           lr))


def test_merged_rows_match_kernel_and_twin():
    rng = np.random.RandomState(0)
    w = _table(rng)
    rows = [0, 3, 7, 11]
    vals = rng.normal(0, 1, (4, 6)).astype("float32")
    want_k = np.asarray(embedding_sgd_pallas(
        jnp.asarray(w), jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
        0.05))
    want_j = np.asarray(embedding_sgd_jnp(
        jnp.asarray(w), jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
        0.05))
    for got in _port(w, rows, vals, 0.05):
        np.testing.assert_allclose(got, want_k, **PALLAS_TOL)
        np.testing.assert_allclose(got, want_j, **PALLAS_TOL)


def test_duplicates_and_sentinels():
    """Unmerged duplicate ids and sentinel padding (12): the port merges
    inside; the reference merges first, as its sgd op does. Untouched rows
    stay bitwise."""
    rng = np.random.RandomState(1)
    w = _table(rng)
    rows = [1, 3, 3, 0, 7, 12, 3, 12]
    vals = rng.normal(0, 1, (8, 6)).astype("float32")
    want_k = _pallas_merged(w, rows, vals, 0.05, 12)
    want_j = np.asarray(embedding_sgd_jnp(
        jnp.asarray(w), jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
        0.05))
    untouched = [2, 4, 5, 6, 8, 9, 10, 11]
    for got in _port(w, rows, vals, 0.05):
        np.testing.assert_allclose(got, want_k, **PALLAS_TOL)
        np.testing.assert_allclose(got, want_j, **SCATTER_TOL)
        np.testing.assert_array_equal(got[untouched], w[untouched])


def test_all_sentinels_is_identity():
    rng = np.random.RandomState(2)
    w = _table(rng)
    vals = rng.normal(0, 1, (3, 6)).astype("float32")
    want = np.asarray(embedding_sgd_pallas(
        jnp.asarray(w), jnp.full((3,), 12, jnp.int32), jnp.asarray(vals),
        0.5))
    np.testing.assert_array_equal(want, w)
    for got in _port(w, [12, 12, 12], vals, 0.5):
        np.testing.assert_array_equal(got, w)


def test_traced_learning_rate():
    """The reference's jit test: lr a traced float32 scalar; here a
    float32 tensor, as the sgd op passes its LearningRate."""
    rng = np.random.RandomState(3)
    w = _table(rng)
    rows = [2, 5]
    vals = rng.normal(0, 1, (2, 6)).astype("float32")
    f = jax.jit(lambda w, r, v, lr: embedding_sgd_pallas(w, r, v, lr))
    want = np.asarray(f(jnp.asarray(w), jnp.asarray(rows, jnp.int32),
                        jnp.asarray(vals), jnp.float32(0.1)))
    for got in _port(w, rows, vals, np.float32(0.1)):
        np.testing.assert_allclose(got, want, **PALLAS_TOL)


def test_scatter_plain_chain_matches_jnp_twin():
    """The plain op chain's unmerged scatter is the reference's jnp branch:
    the same adds in the same order, bitwise."""
    rng = np.random.RandomState(4)
    w = _table(rng)
    rows = [1, 3, 3, 0, 7, 12, 3, 12]
    vals = rng.normal(0, 1, (8, 6)).astype("float32")
    want = np.asarray(embedding_sgd_jnp(
        jnp.asarray(w), jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
        jnp.float32(0.05)))
    got = embk.embedding_sgd_scatter(
        torch.from_numpy(w), torch.tensor(rows), torch.from_numpy(vals),
        torch.tensor(0.05)).numpy()
    np.testing.assert_array_equal(got, want)


SHAPES = [(3, 5), (1037,), (7, 3, 2), (1,), (2049,)]


def test_sgd_arena_matches_pallas():
    """Odd sizes (none a multiple of the reference's 1024-element tile); the
    same p − lr·g, up to XLA's fused multiply-add."""
    rng = np.random.RandomState(5)
    ps, gs = ([rng.normal(0, 1, s).astype("float32") for s in SHAPES]
              for _ in range(2))
    arenas = [jax_opk.flatten_arena([jnp.asarray(a) for a in xs])[0]
              for xs in (ps, gs)]
    want = jax_opk.split_arena(jax_opk.sgd_arena_pallas(*arenas, 0.05),
                               SHAPES)
    tp, tg = ([torch.from_numpy(a.copy()) for a in xs] for xs in (ps, gs))
    lr = torch.tensor(0.05)
    for got in (opk.sgd_arena(tp, tg, lr), opk.sgd_arena_torch(tp, tg, lr)):
        assert opk.launches["sgd_arena"] == 0
        for g, w, p, gr in zip(got, want, tp, tg):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **PALLAS_TOL)
            # and bitwise the per-parameter sgd expression
            assert torch.equal(g, p - lr * gr)


def test_supported_and_bf16_table_fallback():
    """supported(): a 2-D float32 table and 2-D values. The sgd op's sparse
    branch under the kernel route sends a bfloat16 table to the plain
    chain, counted; a float32 one to the kernel wrapper, uncounted."""
    f32 = torch.zeros(6, 4)
    assert embk.supported(f32, torch.zeros(3, 4))
    assert not embk.supported(f32.bfloat16(), torch.zeros(3, 4))
    assert not embk.supported(torch.zeros(6, 4, 2), torch.zeros(3, 4, 2))
    assert not embk.supported(f32, torch.zeros(3))
    rng = np.random.RandomState(6)
    g = SparseRows(torch.tensor([1, 4, 1, 6]),
                   torch.from_numpy(rng.normal(0, 1, (4, 4))
                                    .astype("float32")), 6)
    lr = torch.tensor(0.1)
    tfluid.set_flags({"kernel_tier": "cuda"})
    ttier.reset_fallback_counts()
    w = torch.from_numpy(rng.normal(0, 1, (6, 4)).astype("float32"))
    got = optimizer_ops._sgd_apply(w, g, lr)
    assert ttier.fallback_counts() == {}
    assert torch.equal(got, embk.embedding_sgd_torch(w, g.rows, g.values,
                                                     lr))
    wb = w.bfloat16()
    got = optimizer_ops._sgd_apply(wb, g, lr)
    assert ttier.fallback_counts() == {"embedding_sgd": 1}
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, embk.embedding_sgd_scatter(
        wb, g.rows, g.values.bfloat16(), lr))


def test_wrappers_reject_what_the_kernels_do_not_take():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernels would build and "
                    "run")
    meta = dict(device="meta")
    w = torch.empty((6, 4), **meta)
    rows = torch.empty((3,), dtype=torch.int64, **meta)
    lr = torch.empty((), **meta)
    with pytest.raises(ValueError, match="float32"):
        embk.embedding_sgd(w, rows, torch.empty((3, 5), **meta), lr)
    with pytest.raises(ValueError, match="int64"):
        embk.embedding_sgd(w, rows.int(), torch.empty((3, 4), **meta), lr)
    with pytest.raises(ValueError, match="learning rate"):
        embk.embedding_sgd(w, rows, torch.empty((3, 4), **meta), 0.1)
    with pytest.raises(ValueError, match="non-empty"):
        opk.sgd_arena([], [], lr)


def _train_embedding(fluid, steps=4):
    """tests/test_fused_embedding_sgd.py's program: ragged ids with repeats
    and padding, sequence_pool(sum), fc(1), mean square error, SGD(0.1)."""
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[1], dtype="int64",
                                lod_level=1)
        emb = fluid.layers.embedding(ids, size=[15, 8], is_sparse=True)
        feat = fluid.layers.sequence_pool(emb, "sum")
        pred = fluid.layers.fc(feat, size=1)
        label = fluid.layers.data("y", shape=[1])
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(pred, label)))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss, startup)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(5)
    return {"ids": [np.array([[0], [4], [4], [9]], "int64"),
                    np.array([[2]], "int64"),
                    np.array([[14], [0]], "int64")],
            "y": rng.normal(0, 1, (3, 1)).astype("float32")}


@pytest.mark.parametrize("routes", [("torch", "jnp"), ("cuda", "pallas")])
def test_sgd_op_sparse_branch_dispatches_kernel(routes, monkeypatch):
    """End to end: the port's route against the reference's, from the
    reference's startup state; 4 steps' losses and the final table. The
    kernel route calls the embedding wrapper once a step and nothing
    falls back; the plain route never calls it."""
    jfluid.set_flags({"kernel_tier": routes[1]})
    jmain, jstart, jloss = _train_embedding(jfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    names = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and not v.is_data]
    init = {n: np.array(jscope.find_var(n)) for n in names}
    want = [float(np.asarray(jexe.run(jmain, feed=_feed(),
                                      fetch_list=[jloss], scope=jscope)[0]))
            for _ in range(4)]

    calls = [0]
    real = embk.embedding_sgd

    def counted(*args):
        calls[0] += 1
        return real(*args)

    monkeypatch.setattr(embk, "embedding_sgd", counted)
    tfluid.set_flags({"kernel_tier": routes[0]})
    ttier.reset_fallback_counts()
    tmain, _, tloss = _train_embedding(tfluid)
    tscope = tfluid.io.scope_from_numpy(init, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(texe.run(tmain, feed=_feed(), fetch_list=[tloss],
                          scope=tscope)[0]) for _ in range(4)]
    assert calls[0] == {"torch": 0, "cuda": 4}[routes[0]]
    assert ttier.fallback_counts() == {}
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0]
    table = "embedding_0.w_0"
    np.testing.assert_allclose(tscope.find_var(table).numpy(),
                               np.asarray(jscope.find_var(table)),
                               rtol=1e-5, atol=1e-6)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_embedding_sgd.py on the GPU machine)")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 6])
def test_embedding_kernel_is_bitwise_the_plain_version_on_card(d):
    """Zipf-skewed ids with long runs, sentinels and an out-of-range id:
    the kernel's table is bitwise the plain version's, in place, one
    launch; an all-sentinel call changes nothing."""
    _need_card()
    rng = np.random.RandomState(7)
    v, n = 300, 700
    rows = np.minimum(rng.zipf(1.3, n) - 1, v + 3)
    w = torch.from_numpy(rng.normal(0, 1, (v, d)).astype("float32")).cuda()
    vals = torch.from_numpy(rng.normal(0, 1, (n, d))
                            .astype("float32")).cuda()
    rows = torch.from_numpy(rows.astype("int64")).cuda()
    lr = torch.tensor([0.05], device="cuda")
    want = embk.embedding_sgd_torch(w, rows, vals, lr)
    got = w.clone()
    before = embk.launches["embedding_sgd"]
    assert embk.embedding_sgd(got, rows, vals, lr) is got
    torch.cuda.synchronize()
    assert embk.launches["embedding_sgd"] == before + 1
    assert torch.equal(got, want)
    same = w.clone()
    embk.embedding_sgd(same, torch.full_like(rows, v), vals, lr)
    torch.cuda.synchronize()
    assert torch.equal(same, w)


@pytest.mark.cuda
def test_sgd_arena_kernel_is_bitwise_the_plain_version_on_card():
    _need_card()
    rng = np.random.RandomState(8)
    ps, gs = ([torch.from_numpy(rng.normal(0, 1, s).astype("float32"))
               .cuda() for s in SHAPES] for _ in range(2))
    lr = torch.tensor([0.05], device="cuda")
    want = opk.sgd_arena_torch(ps, gs, lr)
    before = opk.launches["sgd_arena"]
    got = opk.sgd_arena([p.clone() for p in ps], gs, lr)
    torch.cuda.synchronize()
    assert opk.launches["sgd_arena"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n, nrows, want", [
    (embk.FUSED_MAX - 1, 2073, "fused"),
    (embk.FUSED_MAX, 2073, "fused"),
    (embk.FUSED_MAX + 1, 2073, "keys32"),
    (1, 1, "fused"),
    (embk.FUSED_MAX + 1, 2 ** 32 - 2, "keys32"),
    (embk.FUSED_MAX + 1, 2 ** 32 - 1, "keys64"),
    (128, 2 ** 53, "keys64"),
])
def test_sort_path_at_the_one_launch_limit(n, nrows, want):
    """One launch that sorts in-CTA up to FUSED_MAX entries; above it the
    library sort, of 4-byte keys while every row plus 1 fits one."""
    assert embk.sort_path(n, nrows) == want


@pytest.mark.parametrize("n", [embk.FUSED_MAX - 1, embk.FUSED_MAX,
                               embk.FUSED_MAX + 1])
def test_wrapper_takes_the_path_sort_path_names(n, monkeypatch):
    """The wrapper hands checked operands to one launch on the path
    ``sort_path`` picks, at the one-launch limit and either side of it;
    an empty call launches nothing."""
    seen = []
    monkeypatch.setattr(embk, "_launch", lambda *a: seen.append(a[-1]))
    meta = dict(device="meta")
    w = torch.empty((2073, 32), **meta)
    rows = torch.empty((n,), dtype=torch.int64, **meta)
    lr = torch.empty((1,), **meta)
    assert embk.embedding_sgd(w, rows, torch.empty((n, 32), **meta),
                              lr) is w
    assert seen == [embk.sort_path(n, 2073)]
    embk.embedding_sgd(w, rows[:0], torch.empty((0, 32), **meta), lr)
    assert seen == [embk.sort_path(n, 2073)]


@pytest.mark.parametrize("d, ptr, want", [
    (32, 0, 4), (64, 0, 4), (64, 8, 2), (64, 4, 1), (96, 8, 2), (128, 0, 4),
    (130, 0, 2), (33, 0, 1), (6, 0, 2), (6, 4, 1)])
def test_columns_per_copy(d, ptr, want):
    """16-byte copies and loads where D and the values' base allow them,
    else 8-byte, else 4-byte."""
    class Fake:
        shape = (10, d)

        def data_ptr(self):
            return 4096 + ptr

    assert embk._vec(Fake(), Fake()) == want


def _hot_rows(rng, v, n_hot, n_other, hot=7):
    """n_hot entries of row ``hot`` spread among n_other Zipf-skewed rows,
    sentinels (v, v + 5) and negative rows (-1, -3) among them, all
    shuffled: the hot run outlasts many staging chunks and crosses
    several slices once sorted."""
    other = np.minimum(rng.zipf(1.2, n_other) - 1, v - 1)
    rows = np.concatenate([np.full(n_hot, hot), other,
                           [v, v + 5, -1, -3] * 16])
    return rng.permutation(rows)


def _check_bitwise(w, rows, vals, lr, path=None):
    """The kernel (on ``path``, or the wrapper's choice) against the plain
    version: bitwise, in place, one launch."""
    want = embk.embedding_sgd_torch(w, rows, vals, lr)
    got = w.clone()
    before = embk.launches["embedding_sgd"]
    if path is None:
        assert embk.embedding_sgd(got, rows, vals, lr) is got
    else:
        embk._launch(got, rows, vals, lr, path)
    torch.cuda.synchronize()
    assert embk.launches["embedding_sgd"] == before + 1
    assert torch.equal(got, want)


def _cuda_operands(rng, v, d, rows):
    w = torch.from_numpy(rng.normal(0, 1, (v, d)).astype("float32")).cuda()
    vals = torch.from_numpy(rng.normal(0, 1, (len(rows), d))
                            .astype("float32")).cuda()
    return (w, torch.from_numpy(np.asarray(rows, "int64")).cuda(), vals,
            torch.tensor([0.05], device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 33])
def test_hot_run_is_bitwise_the_plain_version_on_card(d):
    """A 5 000-entry run of one row (dozens of staging chunks, many
    slices) among short runs, sentinels and negative rows."""
    _need_card()
    rng = np.random.RandomState(9)
    rows = _hot_rows(rng, 500, 5000, 3000)
    _check_bitwise(*_cuda_operands(rng, 500, d, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("run", [200, 255, 256, 257, 600])
def test_runs_across_slices_are_bitwise_on_card(run):
    """Runs of equal length, so that their heads and ends fall at every
    offset of the 256-entry slices, some spanning whole slices."""
    _need_card()
    rng = np.random.RandomState(run)
    rows = rng.permutation(np.repeat(np.arange(0, 40, 3), run))
    _check_bitwise(*_cuda_operands(rng, 64, 64, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [embk.FUSED_MAX - 1, embk.FUSED_MAX,
                               embk.FUSED_MAX + 1])
@pytest.mark.parametrize("d", [32, 64, 128, 33])
def test_one_launch_limit_is_bitwise_on_card(n, d):
    """At the one-launch limit and either side of it, with a run long
    enough for the whole CTA, sentinels and negative rows."""
    _need_card()
    rng = np.random.RandomState(n + d)
    rows = _hot_rows(rng, 300, 100, n - 164)
    assert len(rows) == n
    _check_bitwise(*_cuda_operands(rng, 300, d, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fused", "keys32", "keys64"])
@pytest.mark.parametrize("d", [32, 64, 128, 33, 300, 1100])
def test_every_path_is_bitwise_on_card(path, d):
    """The same entries through each sort path, one launch each; at D 300
    a thread adds two columns of a staged run, and D 1100 is past the
    staged rows' limit, so its long run is one warp's."""
    _need_card()
    rng = np.random.RandomState(d)
    rows = _hot_rows(rng, 200, 300, 500)
    _check_bitwise(*_cuda_operands(rng, 200, d, rows), path=path)
