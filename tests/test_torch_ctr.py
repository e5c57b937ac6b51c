"""The sparse CTR slice on the CPU: Wide&Deep trained locally and through
transpiled parameter servers, the sharded lookup table's routing ops, and
an ``is_sparse`` table sharded over tp under dp.

* Wide&Deep at a small size (tables of 1000 rows, width 8, 4 fields,
  hidden 32/16/8, batch 64): the port's local run matches the reference's
  over 3 steps from the same parameters, and the port's run through two
  pserver shard processes (sync, one trainer) matches its local run.
* ``split_ids`` and ``split_selected_rows`` equal the reference's outputs.
* The counterpart of tests/test_sparse.py's
  ``test_tp_sharded_embedding_sparse_matches_single_device`` on 4 gloo
  ranks (dp 2 x tp 2) at the reference's tolerances, a LoD feed whose
  ranks hold different entry counts under dp, and the ZeRO-1 case the
  step still refuses.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.distributed import PserverSupervisor, install_params
from paddle_tpu_torch.parallel.launch import RankPool
from paddle_tpu_torch.testing import multichip

from torch_cross import build_both, ref_state, port_scope

VOCAB, EMB, FIELDS, DENSE, HIDDEN, BATCH, LR = 1000, 8, 4, 13, (32, 16, 8), \
    64, 0.05
STEPS = 3
# port vs reference, and pserver vs local, per step's loss
LOSS_RTOL = 1e-5
# the reference's tolerances (tests/test_sparse.py)
RTOL, ATOL = 2e-5, 2e-6
RANKS = 4


def wide_deep(fluid, fused=True):
    """Wide&Deep CTR: an is_sparse [VOCAB, EMB] table over FIELDS ids,
    concatenated with DENSE features, through relu fcs HIDDEN to 1 (deep);
    an is_sparse [VOCAB, 1] table summed over the fields plus fc(dense, 1)
    (wide); mean sigmoid cross-entropy against the click; SGD."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        ids = L.data("ids", shape=[FIELDS, 1], dtype="int64")
        dense = L.data("dense", shape=[DENSE])
        click = L.data("click", shape=[1])
        deep = L.reshape(L.embedding(
            ids, size=[VOCAB, EMB], is_sparse=True,
            param_attr=fluid.ParamAttr(name="deep_emb")), [-1, FIELDS * EMB])
        h = L.concat([deep, dense], axis=1)
        for width in HIDDEN:
            h = L.fc(h, size=width, act="relu")
        wide = L.reshape(L.embedding(
            ids, size=[VOCAB, 1], is_sparse=True,
            param_attr=fluid.ParamAttr(name="wide_emb")), [-1, FIELDS])
        logit = L.elementwise_add(
            L.elementwise_add(L.fc(h, size=1),
                              L.reduce_sum(wide, dim=1, keep_dim=True)),
            L.fc(dense, size=1))
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, click))
        fluid.optimizer.SGD(LR, fused=fused).minimize(loss, startup)
    return main, startup, loss


def ctr_feed(seed):
    """ids [BATCH, FIELDS, 1] (Zipf-ish), dense [BATCH, DENSE], and clicks
    from a seeded logistic model of the ids and dense features."""
    rng = np.random.RandomState(seed)
    ranks = np.minimum(rng.zipf(1.3, (BATCH, FIELDS)) - 1, VOCAB - 1)
    ids = (ranks * 7919 + np.arange(FIELDS) * 131) % VOCAB
    dense = np.log1p(rng.exponential(2.0, (BATCH, DENSE))).astype("float32")
    w = np.random.RandomState(99).normal(0, 1, VOCAB)
    score = w[ids].sum(1) + dense @ np.linspace(-0.5, 0.5, DENSE)
    click = (rng.rand(BATCH) < 1 / (1 + np.exp(-score))).astype("float32")
    return {"ids": ids.astype("int64")[..., None], "dense": dense,
            "click": click[:, None]}


FEEDS = [ctr_feed(s) for s in range(STEPS)]


def _local(exe, main, loss, scope):
    return [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0])) for f in FEEDS]


@pytest.fixture(scope="module")
def both():
    both = build_both(wide_deep)
    jmain, jstart, jloss = both["ref"]
    jexe, jscope, state = ref_state(jmain, jstart)
    ref = _local(jexe, jmain, jloss, jscope)
    return both, state, ref


def test_wide_deep_local_matches_the_reference(both):
    """The port's local Wide&Deep (both tables through the sparse update,
    the dense set through fused SGD) against the reference's, 3 steps
    from the same parameters; the loss falls."""
    progs, state, ref = both
    main, _, loss = progs["port"]
    ops = [op.type for op in main.global_block().ops]
    assert ops.count("fused_sgd") == 1 and "sgd" not in ops
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = _local(exe, main, loss, port_scope(state))
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_wide_deep_through_pserver_shards_matches_local(both):
    """The same program transpiled (sync, 1 trainer) onto 2 shard
    processes under PserverSupervisor: step 1 is the local step's loss
    bitwise (the same forward from the same parameters), and 3 steps agree
    with the local run; the sparse grads ship as touched rows only."""
    progs, state, _ = both
    main, startup, loss = progs["port"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    local = _local(exe, main, loss, port_scope(state))
    t = tfluid.DistributeTranspiler().transpile(
        0, program=main, pservers="127.0.0.1:6170,127.0.0.1:6171",
        trainers=1, startup_program=startup)
    assert t.optimizer == "sgd" and t.opt_kwargs == {"lr": LR}
    assert t.sparse_param_names == ["deep_emb", "wide_emb"]
    scope = port_scope(state)
    names = [p for p, _ in t.params_grads]
    grads = [g for _, g in t.params_grads]
    trainer = t.get_trainer_program()
    with PserverSupervisor(n_servers=2, optimizer=t.optimizer,
                           opt_kwargs=t.opt_kwargs, mode="sync",
                           fan_in=1) as sup:
        assert sup.wait_ready(60.0)
        client = t.trainer_client(
            endpoints=[f"{h}:{p}" for h, p in sup.addresses])
        client.init_params({n: scope.find_var(n).numpy() for n in names})
        got = []
        for f in FEEDS:
            install_params(scope, client.pull(), device=exe.device)
            out = exe.run(trainer, feed=f, fetch_list=[loss] + grads,
                          scope=scope)
            sparse = dict(zip(grads, out[1:]))["deep_emb@GRAD"]
            assert isinstance(sparse, SparseRows)
            before = client.wire_stats()["bytes_sent"]
            client.push(dict(zip(names, out[1:])))
            pushed = client.wire_stats()["bytes_sent"] - before
            # the two tables' touched rows, not the 32 KiB + 4 KiB tables
            assert pushed < VOCAB * (EMB + 1) * 4
            got.append(float(out[0]))
        client.close()
    assert got[0] == local[0]
    np.testing.assert_allclose(got, local, rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# the sharded lookup table's routing ops
# ---------------------------------------------------------------------------

def _split_ids_program(fluid, n):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[1], dtype="int64")
        outs = [main.global_block().create_var(name=f"shard{i}",
                                               dtype="int64")
                for i in range(n)]
        main.global_block().append_op(
            "split_ids", inputs={"Ids": [ids.name]},
            outputs={"Out": [o.name for o in outs]})
    return main, startup


@pytest.mark.parametrize("n", [1, 3, 4])
def test_split_ids_equals_the_reference(n):
    """id % n routing in the ids' order, [k, 1] outputs (an empty shard
    included), the values the reference's host-side op gives."""
    rng = np.random.RandomState(n)
    ids = rng.randint(0, 50, (20, 1)).astype("int64")
    ids[:3] = [[0], [4], [8]]
    both = build_both(lambda f: _split_ids_program(f, n))
    names = [f"shard{i}" for i in range(n)]
    jexe = jfluid.Executor(jfluid.CPUPlace(), mode="eager")
    ref = jexe.run(both["ref"][0], feed={"ids": ids}, fetch_list=names)
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = texe.run(both["port"][0], feed={"ids": ids}, fetch_list=names)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        # the reference's int64 ids run as int32 (JAX without x64)
        assert g.dtype == np.int64 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    if n == 4:   # a shard no id routes to is [0, 1]
        got = texe.run(both["port"][0], feed={"ids": ids * 4},
                       fetch_list=names)
        assert [g.shape for g in got][1:] == [(0, 1)] * 3


def _split_rows_program(fluid, sections):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        block = main.global_block()
        x = block.create_var(name="sr")
        outs = [block.create_var(name=f"part{i}")
                for i in range(len(sections))]
        block.append_op("split_selected_rows", inputs={"X": [x.name]},
                        outputs={"Out": [o.name for o in outs]},
                        attrs={"height_sections": list(sections)})
    return main, startup


@pytest.mark.parametrize("sections", [(5, 5), (3, 4, 3)])
def test_split_selected_rows_equals_the_reference(sections):
    """Every output keeps the input's entry count; out-of-range entries
    are the section's height with zero values; in-range rows rebased."""
    from paddle_tpu.core.sparse import SparseRows as JSparseRows
    import jax.numpy as jnp

    rows = np.array([0, 4, 7, 9, 4, 3, 10], np.int64)   # 10: a sentinel
    vals = np.arange(14, dtype=np.float32).reshape(7, 2)
    names = [f"part{i}" for i in range(len(sections))]
    both = build_both(lambda f: _split_rows_program(f, sections))
    jexe = jfluid.Executor(jfluid.CPUPlace(), mode="eager")
    jscope = jfluid.Scope()
    jscope.set("sr", JSparseRows(jnp.asarray(rows, jnp.int32),
                                 jnp.asarray(vals), nrows=10))
    ref = jexe.run(both["ref"][0], feed={}, fetch_list=names, scope=jscope)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    tscope.set("sr", SparseRows(torch.from_numpy(rows),
                                torch.from_numpy(vals), nrows=10))
    got = texe.run(both["port"][0], feed={}, fetch_list=names, scope=tscope)
    for g, r, h in zip(got, ref, sections):
        assert isinstance(g, SparseRows) and g.nrows == r.nrows == h
        np.testing.assert_array_equal(g.rows.numpy(), np.asarray(r.rows))
        np.testing.assert_array_equal(g.values.numpy(),
                                      np.asarray(r.values))
        np.testing.assert_array_equal(g.to_dense().numpy(),
                                      np.asarray(r.to_dense()))


# ---------------------------------------------------------------------------
# the is_sparse table sharded over tp, its gradient summed over dp
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    with RankPool(RANKS, "gloo", timeout=120) as p:
        yield p


def _sharded(pool, build_kw, feeds, axes, plan_kw=None, local=False):
    """The reference's single-device losses from its startup state, the
    port's single-device run from that state, and the sharded step on
    every rank (which must agree)."""
    jfluid.framework.reset_unique_name()
    jmain, jstart, jloss = multichip.build_sparse_embedding(
        fluid=jfluid, **build_kw)
    jexe, jscope, state = ref_state(jmain, jstart)
    ref = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                     scope=jscope)[0])) for f in feeds]
    build = multichip.build_sparse_embedding
    single = multichip.single_run(build, build_kw, feeds, state=state)
    ranks = pool.run(multichip.sharded_run, build, build_kw, feeds, axes,
                     plan_kw, state, local_feeds=local)
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
    return ref, single, ranks[0]


def test_tp_sharded_embedding_sparse_matches_single_device(pool):
    """The counterpart of tests/test_sparse.py:252: the table [12, 16]
    sharded over tp (each rank's columns), its SparseRows gradient
    gathered over dp and applied to each rank's shard; losses and the
    table match one device at the reference's tolerances."""
    feeds = [multichip.sparse_embedding_feed(12)] * 3
    ref, single, got = _sharded(pool, {}, feeds, ("dp", "tp"))
    assert got["mesh"] == {"dp": 2, "tp": 2}
    w = "embedding_0.w_0"
    assert got["specs"][w] == [None, "tp"]
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["params"][w], single["params"][w],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(single["losses"], ref, rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    w0 = single["params"][w]
    untouched = sorted(set(range(12)) - set(feeds[0]["ids"].ravel()))
    assert untouched   # some rows never looked up: they must not move
    np.testing.assert_array_equal(got["params"][w][untouched],
                                  w0[untouched])


@pytest.mark.parametrize("local", [False, True])
def test_dp_sparse_lod_feed_matches_single_device(pool, local):
    """A LoD id feed over dp. Split by place_feed, the ranks keep the
    whole batch's padded length; prepared by each rank from its own
    sequences (``local``), each pads to its own longest, so the ranks'
    SparseRows hold different entry counts and are padded to the largest
    with sentinel rows before the gather. Both match one device."""
    feed = multichip.sparse_embedding_feed(12, lod=True, seed=4)
    lens = [len(s) for s in feed["ids"]]
    if local:   # 4 dp ranks of 2 sequences: their padded lengths differ
        pads = {max(lens[i:i + 2]) for i in range(0, 8, 2)}
        assert len(pads) > 1, lens
    ref, single, got = _sharded(pool, {"lod": True}, [feed] * 3, ("dp",),
                                local=local)
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=RTOL,
                               atol=ATOL)
    for n, w in single["params"].items():
        np.testing.assert_allclose(got["params"][n], w, rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    np.testing.assert_allclose(single["losses"], ref, rtol=1e-5)


def test_zero1_sharded_state_of_a_sparse_table_raises(pool):
    """An is_sparse table whose momentum is sharded over dp (ZeRO-1) has
    no form in the step: it raises when the step is built, naming it."""
    errs = pool.run(multichip.sharded_error,
                    multichip.build_sparse_embedding, {"opt": "momentum"},
                    multichip.sparse_embedding_feed(12), ("dp",),
                    {"shard_opt_state": True})
    assert all(e and "is_sparse" in e and "ZeRO-1" in e for e in errs), errs
