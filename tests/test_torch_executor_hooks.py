"""The port Executor's surface beyond ``run`` on the CPU: ``run_steps`` /
``prepare_steps`` / ``run_prepared``, the ``check_nan_inf``, ``benchmark``
and ``obs_op_metrics`` hooks, the per-version analysis cache, dispatch
coverage, ``ExecContext.run_sub_block`` and ``has_input``.

``run_steps`` is an eager loop of ``run()`` steps over feeds staged once,
so it is held bitwise to the same number of ``run()`` calls (the
reference's tests/test_run_steps.py holds its scan within 1e-5), and
across packages to the reference's ``run_steps`` within the tolerance of
tests/test_torch_training.py. The hooks are held to the reference's eager
executor (tests/test_observability.py:46, tests/test_obs_plane.py:643).
"""

import collections
import re

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.testing import models as JM

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.lod import LoDArray
from paddle_tpu_torch.core.sparse import SparseRows
from paddle_tpu_torch.obs import metrics as obsm
from paddle_tpu_torch.testing import models as M

CPU = fluid.CPUPlace()
# tests/test_torch_training.py's tolerances: losses, and final state as
# max|Δ| / max|ref| per tensor
TOL = dict(rtol=1e-4, atol=1e-5)
STATE_REL = 3e-3
HOOK_FLAGS = ("check_nan_inf", "benchmark", "obs_op_metrics")


@pytest.fixture(autouse=True)
def _flags_off():
    yield
    fluid.set_flags({f: False for f in HOOK_FLAGS})
    jfluid.set_flags({f: False for f in HOOK_FLAGS})


def _clone_scope(scope):
    """A second scope holding copies of every value, the generator's state
    included: two runs from it start from the same state."""
    out = fluid.Scope()
    for n in scope.local_names():
        v = scope.find_var(n)
        if isinstance(v, torch.Generator):
            g = torch.Generator(device=v.device)
            g.set_state(v.get_state())
            v = g
        elif isinstance(v, torch.Tensor):
            v = v.clone()
        out.set(n, v)
    return out


def _state(main, scope):
    return {n: scope.find_var(n).clone()
            for n, v in main.global_block().vars.items()
            if v.persistable and scope.has_var(n)}


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


# ---------------------------------------------------------------------------
# run_steps / prepare_steps / run_prepared
# ---------------------------------------------------------------------------

def _mlp():
    main, startup, loss = M.build_mlp(dim=8, classes=4, hidden=16, seed=11)
    feeds = [M.mlp_feed(8, dim=8, classes=4, seed=s) for s in range(3)]
    return main, startup, loss, feeds


def _lod_pool():
    """tests/test_run_steps.py's LoD model (sum pooling: the port's
    sequence_pool takes LAST and SUM), every feed padded to 8."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(words, size=(50, 8))
        pooled = fluid.layers.sequence_pool(emb, pool_type="sum")
        logits = fluid.layers.fc(pooled, size=3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(0.1).minimize(loss, startup)
    rng = np.random.RandomState(11)
    feeds = []
    for _ in range(3):
        seqs = [rng.randint(0, 50, (int(rng.randint(2, 7)), 1))
                .astype("int64") for _ in range(4)]
        feeds.append({"words": fluid.pack_sequences(seqs, max_len=8),
                      "label": rng.randint(0, 3, (4, 1)).astype("int64")})
    return main, startup, loss, feeds


def _lstm():
    """The LSTM text classifier (narrow) with Adam(fused): two distinct LoD
    feeds of one padded length, as chip_smoke.py phase 17 feeds it."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        prob = M.lstm_textcls(words, vocab=50, emb=8, hidden=16)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam(2e-3, fused=True).minimize(loss, startup)
    rng = np.random.RandomState(5)
    feeds = [{"words": [rng.randint(0, 50, (n, 1)).astype("int64")
                        for n in (7, 3, 5)],
              "label": rng.randint(0, 2, (3, 1)).astype("int64")}
             for _ in range(2)]
    return main, startup, loss, feeds


def _word2vec():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(f"w{i}", shape=[1], dtype="int64")
                 for i in range(4)]
        nextw = fluid.layers.data("nextw", shape=[1], dtype="int64")
        prob = M.ngram_lm(words, dict_size=50, emb=8, hidden=16,
                          is_sparse=True)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, nextw))
        fluid.optimizer.SGD(0.5, fused=True).minimize(loss, startup)
    rng = np.random.RandomState(2)
    feeds = [{n: rng.randint(0, 50, (6, 1)).astype("int64")
              for n in ("w0", "w1", "w2", "w3", "nextw")} for _ in range(2)]
    return main, startup, loss, feeds


MODELS = {"mlp": _mlp, "lod_pool": _lod_pool, "lstm_textcls": _lstm,
          "word2vec_sparse": _word2vec}


def _start(build):
    main, startup, loss, feeds = build()
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, main, loss, feeds, scope


@pytest.mark.parametrize("model", sorted(MODELS))
def test_run_steps_matches_sequential_runs_bitwise(model):
    exe, main, loss, feeds, scope_a = _start(MODELS[model])
    scope_b = _clone_scope(scope_a)
    K = 7  # cycles the feeds: 0, 1, 2, 0, ...
    seq = [exe.run(main, feed=feeds[i % len(feeds)], fetch_list=[loss],
                   scope=scope_a)[0] for i in range(K)]
    multi = exe.run_steps(main, feeds, fetch_list=[loss], scope=scope_b,
                          steps=K)[0]
    assert multi.shape == (K,) + np.shape(seq[0])
    assert np.array_equal(multi, np.stack(seq))
    _assert_bitwise(_state(main, scope_a), _state(main, scope_b))


@pytest.mark.parametrize("model", ["mlp", "lstm_textcls"])
def test_prepare_steps_run_prepared_split(model):
    """Feeds staged once; each run_prepared continues from the scope, as
    the same number of run() calls do (the reference's Prepare /
    RunPreparedContext split)."""
    exe, main, loss, feeds, scope_a = _start(MODELS[model])
    scope_b = _clone_scope(scope_a)
    n = len(feeds)
    seq = [exe.run(main, feed=feeds[i % n], fetch_list=[loss],
                   scope=scope_a)[0] for i in range(2 * n)]
    h = exe.prepare_steps(main, feeds, fetch_list=[loss], scope=scope_b)
    assert isinstance(h.stacked["label"], torch.Tensor)
    assert h.stacked["label"].shape[0] == n
    got = [exe.run_prepared(h)[0] for _ in range(2)]
    assert np.array_equal(np.concatenate(got), np.stack(seq))
    _assert_bitwise(_state(main, scope_a), _state(main, scope_b))


def test_run_steps_repeated_invocation_continues_training():
    exe, main, loss, feeds, scope = _start(_mlp)
    first = exe.run_steps(main, feeds[:2], fetch_list=[loss], scope=scope,
                          steps=10)[0]
    second = exe.run_steps(main, feeds[:2], fetch_list=[loss], scope=scope,
                           steps=10)[0]
    assert second[-1] < first[0]


def test_run_steps_stacks_lod_and_sparse_fetches():
    exe, main, loss, feeds, scope = _start(_word2vec)
    loss_v, grad = exe.run_steps(main, feeds, fetch_list=[
        loss, "shared_w@GRAD"], scope=scope, steps=3)
    assert loss_v.shape == (3,)
    assert len(grad) == 3 and all(isinstance(g, SparseRows) for g in grad)
    exe, main, loss, feeds, scope = _start(_lstm)
    words, = exe.run_steps(main, feeds, fetch_list=["words"], scope=scope,
                           steps=3, return_numpy=False)
    assert isinstance(words, LoDArray)
    assert tuple(words.data.shape[:2]) == (3, 3)
    assert words.lens.tolist()[0] == [7, 3, 5]


def test_prepare_steps_refuses_feeds_that_disagree():
    exe, main, loss, feeds, scope = _start(_mlp)
    with pytest.raises(ValueError, match="same names"):
        exe.prepare_steps(main, [feeds[0], {"img": feeds[1]["img"]}],
                          fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="at least one"):
        exe.prepare_steps(main, [], fetch_list=[loss], scope=scope)


def test_run_steps_matches_the_reference_run_steps():
    """The same MLP, the reference's startup state carried across by name,
    7 steps over 3 feeds: the port's run_steps against the reference's
    (its steps scanned into one XLA computation)."""
    jfluid.framework.reset_unique_name()
    jmain, jstart, jloss = JM.build_mlp(dim=8, classes=4, hidden=16,
                                        seed=11)
    fluid.framework.reset_unique_name()
    main, _, loss = M.build_mlp(dim=8, classes=4, hidden=16, seed=11)
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    feeds = [M.mlp_feed(8, dim=8, classes=4, seed=s) for s in range(3)]
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    state = [n for n, v in jmain.global_block().vars.items()
             if v.persistable and not v.is_data]
    init = {n: np.array(jscope.find_var(n)) for n in state}
    want = jexe.run_steps(jmain, feeds, fetch_list=[jloss], scope=jscope,
                          steps=7)[0]
    scope = fluid.io.scope_from_numpy(init, "cpu")
    got = fluid.Executor(CPU).run_steps(main, feeds, fetch_list=[loss],
                                        scope=scope, steps=7)[0]
    np.testing.assert_allclose(got, want, **TOL)
    for n in state:
        ref = np.asarray(jscope.find_var(n))
        diff = np.abs(scope.find_var(n).numpy() - ref).max()
        assert diff <= STATE_REL * max(np.abs(ref).max(), 1e-12), n


# ---------------------------------------------------------------------------
# check_nan_inf
# ---------------------------------------------------------------------------

def _nan_program(pkg):
    pkg.framework.reset_unique_name()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[4])
        out = pkg.layers.mean(pkg.layers.log(x))  # log of a negative: NaN
    return main, startup, out


def _raise_message(exe, *args, **kw):
    with pytest.raises(FloatingPointError) as ei:
        exe.run(*args, **kw)
    return str(ei.value)


def test_check_nan_inf_names_the_reference_op_and_var():
    bad = {"x": np.array([[1.0, 2.0, -3.0, 4.0]], "float32")}
    msgs = []
    for pkg, exe in ((fluid, fluid.Executor(CPU)),
                     (jfluid, jfluid.Executor(jfluid.CPUPlace(),
                                              mode="eager"))):
        main, startup, out = _nan_program(pkg)
        exe.run(startup)
        pkg.set_flags({"check_nan_inf": True})
        msgs.append(_raise_message(exe, main, feed=bad, fetch_list=[out]))
        ok = exe.run(main, feed={"x": np.abs(bad["x"])}, fetch_list=[out])
        assert np.isfinite(ok[0])
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("NaN in output") and "'log'" in msgs[0]


def test_check_nan_inf_names_the_planted_conv_like_the_reference():
    """One NaN planted in the first conv filter: both packages' eager
    executors name the conv2d that reads it and its output."""
    jfluid.framework.reset_unique_name()
    jmain, jstart, jloss = JM.build_convnet_slice()
    fluid.framework.reset_unique_name()
    main, _, loss = M.build_convnet_slice()
    jexe = jfluid.Executor(jfluid.CPUPlace(), mode="eager")
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    init = {n: np.array(jscope.find_var(n))
            for n, v in jmain.global_block().vars.items()
            if v.persistable and not v.is_data}
    conv = next(op for op in main.global_block().ops if op.type == "conv2d")
    filt = conv.input("Filter")[0]
    init[filt].flat[5] = np.nan
    jscope.set(filt, init[filt])
    scope = fluid.io.scope_from_numpy(init, "cpu")
    feed = M.convnet_feed(2)
    fluid.set_flags({"check_nan_inf": True})
    jfluid.set_flags({"check_nan_inf": True})
    got = _raise_message(fluid.Executor(CPU), main, feed=feed,
                         fetch_list=[loss], scope=scope)
    want = _raise_message(jexe, jmain, feed=feed, fetch_list=[jloss],
                          scope=jscope)
    assert got == want == (f"NaN in output {conv.output('Output')[0]!r} "
                           "of op 'conv2d' (check_nan_inf flag)")
    # off (the default): the same step runs and the NaN propagates
    fluid.set_flags({"check_nan_inf": False})
    out = fluid.Executor(CPU).run(main, feed=feed, fetch_list=[loss],
                                  scope=fluid.io.scope_from_numpy(init,
                                                                  "cpu"))
    assert np.isnan(out[0]).all()


class _Op:
    type = "probe"

    def __init__(self, *names):
        self._names = names

    def output_arg_names(self):
        return list(self._names)


@pytest.mark.parametrize("value, kind", [
    (LoDArray(torch.tensor([[[1.0], [float("nan")]]]),
              torch.tensor([2], dtype=torch.int32)), "NaN"),
    (SparseRows(torch.tensor([0, 3]),
                torch.tensor([[1.0], [float("inf")]]), 4), "Inf"),
    (torch.tensor([1.0, float("-inf")], dtype=torch.bfloat16), "Inf"),
    (torch.tensor([float("nan"), float("inf")], dtype=torch.float16), "NaN"),
    (torch.tensor([1, 2], dtype=torch.int64), None),
    (LoDArray(torch.ones(1, 2, 1), torch.tensor([2], dtype=torch.int32)),
     None),
], ids=["lod_nan", "sparse_inf", "bf16_inf", "fp16_nan", "int", "lod_ok"])
def test_check_nan_inf_sweeps_what_port_ops_emit(value, kind):
    env = {"a": torch.zeros(2), "b": value}
    if kind is None:
        texec._check_op_outputs_finite(_Op("a", "b", "absent"), env)
        return
    with pytest.raises(FloatingPointError, match=f"^{kind} in output 'b' "
                       "of op 'probe'"):
        texec._check_op_outputs_finite(_Op("a", "b"), env)


# ---------------------------------------------------------------------------
# benchmark, obs_op_metrics, profiler spans
# ---------------------------------------------------------------------------

def test_benchmark_prints_one_line_per_op(capsys):
    exe, main, loss, feeds, scope = _start(_mlp)
    capsys.readouterr()
    fluid.set_flags({"benchmark": True})
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    lines = capsys.readouterr().out.splitlines()
    ops = [op.type for op in main.global_block().ops]
    assert len(lines) == len(ops)
    for line, op in zip(lines, ops):
        assert re.fullmatch(rf"\[benchmark\] {op}: \d+\.\d{{3}} ms", line)
    fluid.set_flags({"benchmark": False})
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    assert capsys.readouterr().out == ""


def test_op_metrics_count_without_a_retrace():
    exe, main, loss, feeds, scope = _start(_mlp)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    t0 = obsm.REGISTRY.totals()
    fluid.set_flags({"obs_op_metrics": True})
    for _ in range(3):
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    fluid.set_flags({"obs_op_metrics": False})
    t1 = obsm.REGISTRY.totals()

    def delta(name, a=t0, b=t1):
        return b.get(name, 0) - a.get(name, 0)

    assert delta("paddle_tpu_executor_steps") == 3
    assert delta("paddle_tpu_executor_op_dispatches") == \
        3 * len(main.global_block().ops)
    assert delta("paddle_tpu_executor_op_seconds") > 0
    assert delta("paddle_tpu_executor_retraces") == 0
    # per op type: the program's op inventory x 3
    inventory = collections.Counter(op.type
                                    for op in main.global_block().ops)
    fam = obsm.REGISTRY.get("paddle_tpu_executor_op_dispatches")
    for op_type, n in inventory.items():
        assert fam.labels(op_type=op_type).value >= 3 * n
    # off again: a run adds nothing
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    t2 = obsm.REGISTRY.totals()
    assert delta("paddle_tpu_executor_steps", t1, t2) == 0
    assert delta("paddle_tpu_executor_op_dispatches", t1, t2) == 0


def test_profiler_records_one_span_per_op():
    from paddle_tpu_torch.core import profiler
    exe, main, loss, feeds, scope = _start(_mlp)
    profiler.enable_profiler()
    try:
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
        spans = [name for kind, name, *_ in profiler.events()
                 if kind == "op"]
    finally:
        profiler.disable_profiler()
        profiler.reset_profiler()
    assert spans == [op.type for op in main.global_block().ops]


# ---------------------------------------------------------------------------
# the per-version analysis cache
# ---------------------------------------------------------------------------

def test_analysis_cache_matches_a_fresh_walk():
    from paddle_tpu_torch.core.block_walk import free_reads, written_names
    exe, main, loss, feeds, scope = _start(_mlp)
    for _ in range(2):
        a = texec._analyze_program(main)
        assert a.free == free_reads(main, 0)
        assert a.written == written_names(main, 0)
        block = main.global_block()
        assert a.persistable_written == {
            n for n in a.written if block.var(n).persistable}
        assert a is texec._analyze_program(main)
        # a mutation bumps the version: the next lookup rebuilds
        block.create_var(name="extra", shape=loss.shape, dtype="float32")
        block.append_op("scale", {"X": [loss.name]}, {"Out": ["extra"]},
                        {"scale": 2.0})
        assert texec._analyze_program(main) is not a
    out = exe.run(main, feed=feeds[0], fetch_list=[loss, "extra"],
                  scope=scope)
    assert out[1] == 2.0 * out[0]


def test_analysis_cache_walks_no_block_in_steady_state(monkeypatch):
    exe, main, loss, feeds, scope = _start(_mlp)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    walks = []
    real_free, real_written = texec.free_reads, texec.written_names
    monkeypatch.setattr(texec, "free_reads",
                        lambda *a: walks.append("free") or real_free(*a))
    monkeypatch.setattr(texec, "written_names",
                        lambda *a: walks.append("written")
                        or real_written(*a))
    t0 = obsm.REGISTRY.totals().get("paddle_tpu_executor_retraces", 0)
    for _ in range(3):
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    exe.run_steps(main, feeds, fetch_list=[loss], scope=scope, steps=4)
    assert walks == []
    assert obsm.REGISTRY.totals().get("paddle_tpu_executor_retraces",
                                      0) == t0
    # a new version walks once
    main.global_block().create_var(name="extra", shape=loss.shape,
                                   dtype="float32")
    main.global_block().append_op("scale", {"X": [loss.name]},
                                  {"Out": ["extra"]}, {"scale": 2.0})
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    assert walks == ["free", "written"]


def _chain(n_ops):
    main = fluid.Program()
    b = main.global_block()
    b.create_var(name="x0", shape=(-1, 4), dtype="float32", is_data=True)
    for i in range(n_ops):
        b.create_var(name=f"x{i + 1}", shape=(-1, 4), dtype="float32")
        b.append_op("relu" if i % 2 else "scale", {"X": [f"x{i}"]},
                    {"Out": [f"x{i + 1}"]}, {"scale": 1.0} if i % 2 == 0
                    else {})
    return main, f"x{n_ops}"


def test_flag_reads_do_not_grow_with_the_op_count(monkeypatch):
    """With every hook flag off the op loop reads no flag per op: one
    run() of a 10-op and of a 200-op program read the flags the same
    number of times."""
    exe = fluid.Executor(CPU)
    counts = []
    real = tflags.get_flag
    for n_ops in (10, 200):
        main, out = _chain(n_ops)
        feed = {"x0": np.ones((2, 4), "float32")}
        exe.run(main, feed=feed, fetch_list=[out], scope=fluid.Scope())
        reads = []
        monkeypatch.setattr(tflags, "get_flag",
                            lambda name: reads.append(name) or real(name))
        exe.run(main, feed=feed, fetch_list=[out], scope=fluid.Scope())
        monkeypatch.setattr(tflags, "get_flag", real)
        counts.append(len(reads))
    assert counts[0] == counts[1] and counts[0] <= 6, counts


# ---------------------------------------------------------------------------
# dispatch coverage, run_sub_block, has_input
# ---------------------------------------------------------------------------

def test_op_coverage_writes_each_dispatched_type_once(tmp_path,
                                                      monkeypatch):
    path = tmp_path / "coverage.txt"
    monkeypatch.setattr(registry, "_COVERAGE_PATH", str(path))
    monkeypatch.setattr(registry, "_SEEN", set())
    exe, main, loss, feeds, scope = _start(_mlp)
    for _ in range(2):
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    lines = path.read_text().splitlines()
    assert len(lines) == len(set(lines))
    types = {op.type for op in main.global_block().ops}
    assert types <= set(lines)


def test_run_sub_block_runs_over_the_parent_env():
    name = "_test_run_sub_block"

    @registry.register_op(name, is_control_flow=True)
    def _forward(ctx):
        assert ctx.sub_block().idx == ctx.attr("sub_block")
        ctx.run_sub_block(ctx.attr("sub_block"))

    try:
        main = fluid.Program()
        b0 = main.global_block()
        b0.create_var(name="x", shape=(-1, 3), dtype="float32",
                      is_data=True)
        b0.create_var(name="y", shape=(-1, 3), dtype="float32")
        b0.create_var(name="z", shape=(-1, 3), dtype="float32")
        sub = main.create_block()
        sub.append_op("scale", {"X": ["x"]}, {"Out": ["y"]},
                      {"scale": 3.0})
        main.rollback()
        b0.append_op(name, {"X": ["x"]}, {"Out": ["y"]},
                     {"sub_block": sub.idx})
        b0.append_op("relu", {"X": ["y"]}, {"Out": ["z"]})
        assert registry.get_op_info(name).is_control_flow
        x = np.array([[1.0, -2.0, 3.0]], "float32")
        y, z = fluid.Executor(CPU).run(main, feed={"x": x},
                                       fetch_list=["y", "z"],
                                       scope=fluid.Scope())
        np.testing.assert_array_equal(y, 3 * x)
        np.testing.assert_array_equal(z, np.maximum(3 * x, 0))
    finally:
        registry._REGISTRY.pop(name, None)
    assert not registry.has_op(name)


def _lstm_with_unset_state(pkg):
    """An lstm op whose H0/C0 slots name variables nothing binds."""
    pkg.framework.reset_unique_name()
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 4
    with pkg.program_guard(main, startup):
        words = pkg.layers.data("words", shape=[1], dtype="int64",
                                lod_level=1)
        emb = pkg.layers.embedding(words, size=(20, 8))
        proj = pkg.layers.fc(emb, 4 * 16)
        hidden, _ = pkg.layers.dynamic_lstm(proj, size=4 * 16)
        last = pkg.layers.sequence_last_step(hidden)
    block = main.global_block()
    for slot, name in (("H0", "h0_unset"), ("C0", "c0_unset")):
        block.create_var(name=name, shape=(-1, 16), dtype="float32")
        next(op for op in block.ops if op.type == "lstm").inputs[slot] = \
            [name]
    return main, startup, last


def test_has_input_treats_an_unbound_slot_as_absent():
    """Reference ExecContext.has_input (:147-149): a slot naming a variable
    the env does not hold is absent, so the lstm starts from zeros. Before
    this the port raised 'used before definition' on the same program."""
    jmain, jstart, jlast = _lstm_with_unset_state(jfluid)
    tmain, _, tlast = _lstm_with_unset_state(fluid)
    jexe = jfluid.Executor(jfluid.CPUPlace(), mode="eager")
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    init = {n: np.array(jscope.find_var(n))
            for n, v in jmain.global_block().vars.items()
            if v.persistable and not v.is_data}
    rng = np.random.RandomState(0)
    seqs = [rng.randint(0, 20, (n, 1)).astype("int64") for n in (4, 2)]
    want = jexe.run(jmain, feed={"words": seqs}, fetch_list=[jlast],
                    scope=jscope)[0]
    got = fluid.Executor(CPU).run(
        tmain, feed={"words": seqs}, fetch_list=[tlast],
        scope=fluid.io.scope_from_numpy(init, "cpu"))[0]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
