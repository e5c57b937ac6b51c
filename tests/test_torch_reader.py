"""The port's input pipeline (paddle_tpu_torch/reader, the reader ops and
layers, the executor's side of a reader graph) against
tests/test_reader_pool.py's and tests/test_io_ops.py's contracts and
against the JAX package's readers: the worker pool's order, error and
shutdown contracts; bucket_by_length, batch, shuffle and interleave giving
the reference's batches; the reader graph of both packages popping equal
batches until StopIteration, after which a new pass starts; the double
buffer staging batches as they are."""

import pickle
import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.reader as jreader
from paddle_tpu.recordio import write_records as jwrite

import paddle_tpu_torch.fluid as fluid
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core.lod import LoDArray, pack_sequences
from paddle_tpu_torch.reader.pool import WorkerPool, interleave, pool_map
from paddle_tpu_torch.reader.prefetch import (DeviceFeedIterator,
                                              background_buffer,
                                              double_buffer)
from paddle_tpu_torch.recordio import dumps, write_records


# ---------------------------------------------------------------------------
# WorkerPool core
# ---------------------------------------------------------------------------

def _jitter_square(x):
    time.sleep(0.002 * (x % 3))
    return x * x


def test_pool_ordered_preserves_input_order():
    with WorkerPool(4) as p:
        assert list(p.imap(_jitter_square, range(30), ordered=True)) == \
            [x * x for x in range(30)]


def test_pool_unordered_exactly_once():
    with WorkerPool(4) as p:
        out = list(p.imap(_jitter_square, range(30), ordered=False))
    assert sorted(out) == [x * x for x in range(30)]


def test_pool_worker_exception_propagates():
    def boom(x):
        if x == 7:
            raise ValueError("decode failed on record 7")
        return x

    with WorkerPool(3) as p:
        with pytest.raises(ValueError, match="record 7"):
            list(p.imap(boom, range(20)))


def test_pool_feeder_exception_propagates():
    def bad_source():
        yield 1
        yield 2
        raise OSError("shard truncated")

    with WorkerPool(2) as p:
        with pytest.raises(OSError, match="shard truncated"):
            list(p.imap(lambda x: x, bad_source()))


def test_pool_shutdown_leaks_no_threads():
    p = WorkerPool(4)
    assert list(p.imap(lambda x: -x, range(50))) == [-x for x in range(50)]
    g = p.imap(lambda x: x, range(1000))
    next(g)
    g.close()
    p.shutdown()
    assert p.live_threads() == []
    p.shutdown()


def test_pool_shutdown_mid_stream_raises():
    def slow(x):
        time.sleep(0.005)
        return x

    p = WorkerPool(2)
    g = p.imap(slow, range(500))
    next(g)
    p.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        list(g)
    assert p.live_threads() == []
    with pytest.raises(RuntimeError, match="shut-down"):
        p.imap(lambda x: x, range(3))


def test_pool_shutdown_cancels_background_stagers():
    p = WorkerPool(2)
    it = p.background(lambda: iter(range(100_000)), capacity=2)()
    assert next(it) == 0
    t0 = time.time()
    p.shutdown()
    assert time.time() - t0 < 2.0
    assert p.live_threads() == []


def test_background_buffer_abandon_unblocks_feeder():
    fed = []

    def reader():
        for i in range(10_000):
            fed.append(i)
            yield i

    it = background_buffer(reader, capacity=2)()
    assert next(it) == 0
    it.close()
    time.sleep(0.3)
    n_after_close = len(fed)
    time.sleep(0.2)
    assert len(fed) == n_after_close < 10_000


def test_pool_concurrent_workers():
    barrier = threading.Barrier(4, timeout=10)

    def decode(x):
        barrier.wait()
        return x

    with WorkerPool(4) as p:
        assert sorted(p.imap(decode, range(8), ordered=False)) == \
            list(range(8))


def test_interleave_round_robin_exactly_once():
    r = interleave([lambda: iter([0, 3, 5]), lambda: iter([1, 4]),
                    lambda: iter([2])])
    assert list(r()) == [0, 1, 2, 3, 4, 5]
    assert sorted(r()) == [0, 1, 2, 3, 4, 5]


def test_interleave_max_open_bounds_live_shards():
    started = []

    def shard(i):
        def reader():
            started.append(i)
            yield from (i * 10 + j for j in range(3))
        return reader

    it = interleave([shard(i) for i in range(6)], max_open=2)()
    first = [next(it) for _ in range(4)]
    assert len(started) == 2
    out = first + list(it)
    assert sorted(out) == sorted(i * 10 + j for i in range(6)
                                 for j in range(3))
    assert len(started) == 6


def test_post_hoc_persistable_flip_invalidates_analysis():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[3])
        y = fluid.layers.fc(x, 2)
    a1 = texec._analyze_program(main)
    assert y.name not in a1.persistable_written
    main.global_block().var(y.name).persistable = True
    a2 = texec._analyze_program(main)
    assert a2 is not a1 and y.name in a2.persistable_written


def test_pool_map_transient_pool_cleans_up():
    before = {t.name for t in threading.enumerate()}
    r = pool_map(lambda x: x + 1, lambda: iter(range(40)), thread_num=3)
    assert list(r()) == list(range(1, 41))
    time.sleep(0.05)
    leaked = [t for t in threading.enumerate()
              if t.name.startswith("reader-pool") and t.name not in before
              and t.is_alive()]
    assert leaked == []


def test_shuffle_and_batch_accept_pool():
    with WorkerPool(2) as p:
        batched = treader.batch(treader.shuffle(lambda: iter(range(57)),
                                                buf_size=16, pool=p), 10,
                                pool=p)
        assert sorted(s for b in batched() for s in b) == list(range(57))
    assert p.live_threads() == []


# ---------------------------------------------------------------------------
# the same batches as the reference's readers
# ---------------------------------------------------------------------------

def _samples(n=61):
    rng = np.random.RandomState(4)
    return [(rng.randint(0, 9, (int(rng.randint(1, 15)), 1)), i)
            for i in range(n)]


def _ids(batches):
    return [[s[1] for s in b] for b in batches]


@pytest.mark.parametrize("drop_last", [False, True])
def test_bucket_by_length_and_batch_match_the_reference(drop_last):
    src = _samples()
    for pkg in (jreader, treader):
        assert pkg.bucket_bound_for([4, 8], 3) == 4
        assert pkg.bucket_bound_for([4, 8], 11) == 11
    kw = dict(key=lambda s: len(s[0]), bucket_bounds=[8, 4], batch_size=5,
              drop_last=drop_last)
    want = _ids(jreader.bucket_by_length(lambda: iter(src), **kw)())
    got = _ids(treader.bucket_by_length(lambda: iter(src), **kw)())
    assert got == want and got
    want = _ids(jreader.batch(lambda: iter(src), 7, drop_last=drop_last)())
    assert _ids(treader.batch(lambda: iter(src), 7,
                              drop_last=drop_last)()) == want


def test_shuffle_matches_the_reference_under_one_seed():
    src = list(range(103))
    random.seed(11)
    want = list(jreader.shuffle(lambda: iter(src), 16)())
    random.seed(11)
    got = list(treader.shuffle(lambda: iter(src), 16)())
    assert got == want and got != src and sorted(got) == src


def test_interleave_and_compose_match_the_reference():
    shards = [list(range(i * 10, i * 10 + n)) for i, n in
              enumerate((3, 7, 1, 4))]
    mk = [lambda s=s: iter(s) for s in shards]
    assert list(treader.interleave(mk, max_open=2)()) == \
        list(jreader.interleave(mk, max_open=2)())
    a, b = (lambda: iter(range(4))), (lambda: iter("abcd"))
    assert list(treader.compose(a, b)()) == list(jreader.compose(a, b)())
    with pytest.raises(treader.ComposeNotAligned):
        list(treader.compose(a, lambda: iter("abc"))())
    assert list(treader.firstn(treader.chain(a, a), 6)()) == \
        [0, 1, 2, 3, 0, 1]
    assert list(treader.map_readers(lambda x, y: x * y, a, a)()) == \
        [0, 1, 4, 9]
    assert sorted(treader.xmap_readers(lambda x: x + 1, a, 2, 4)()) == \
        [1, 2, 3, 4]
    c = treader.cache(a)
    assert list(c()) == list(c()) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the reader ops and layers
# ---------------------------------------------------------------------------

def _write_shards(tmp_path, counts, write=write_records, enc=dumps):
    """One recordio file per count; record i is (np-array batch, label i),
    labels globally unique across shards."""
    paths, label = [], 0
    for s, count in enumerate(counts):
        recs = []
        for _ in range(count):
            recs.append(enc((np.full((2, 3), label, "float32"),
                             np.full((2, 1), label, "int64"))))
            label += 1
        p = str(tmp_path / f"shard-{s}.recordio")
        write(p, recs)
        paths.append(p)
    return paths, label


def test_read_op_pops_reader():
    batches = [(np.full((2, 3), i, "float32"), np.full((2, 1), i, "int64"))
               for i in range(3)]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        b = main.global_block()
        b.create_var(name="r")
        b.create_var(name="img")
        b.create_var(name="lbl", dtype="int64")
        b.append_op("read", {"Reader": ["r"]}, {"Out": ["img", "lbl"]}, {})
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    scope.set("r", iter(batches))
    for i in range(3):
        img, lbl = exe.run(main, fetch_list=["img", "lbl"], scope=scope)
        np.testing.assert_allclose(img, batches[i][0])
        assert lbl.dtype == np.int64
    with pytest.raises(StopIteration):
        exe.run(main, fetch_list=["img"], scope=scope)


def test_recordio_sharded_concurrent_decode(tmp_path):
    from paddle_tpu_torch.reader.creator import recordio_sharded

    paths, total = _write_shards(tmp_path, [2, 2, 2, 2])
    barrier = threading.Barrier(4, timeout=10)

    def decode(rec):
        barrier.wait()
        return pickle.loads(rec)

    reader = recordio_sharded(paths, thread_num=4, decoder=decode,
                              ordered=False)
    assert sorted(int(s[1].reshape(-1)[0]) for s in reader()) == \
        list(range(total))


def test_open_files_chain_exactly_once(tmp_path, monkeypatch):
    from paddle_tpu_torch.reader import pool as pool_mod

    paths, total = _write_shards(tmp_path, [3, 5, 2, 4])
    widths = []
    orig = pool_mod.WorkerPool.__init__

    def spying_init(self, thread_num, capacity=None):
        widths.append(thread_num)
        orig(self, thread_num, capacity)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        reader = fluid.layers.open_files(
            paths, thread_num=4, shapes=[[-1, 3], [-1, 1]],
            lod_levels=[0, 0], dtypes=["float32", "int64"])
        img, lbl = fluid.layers.read_file(reader)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    monkeypatch.setattr(pool_mod.WorkerPool, "__init__", spying_init)
    seen = []
    for _ in range(total):
        iv, lv = exe.run(main, fetch_list=[img, lbl], scope=scope)
        assert iv.shape == (2, 3)
        seen.append(int(lv.reshape(-1)[0]))
    with pytest.raises(StopIteration):
        exe.run(main, fetch_list=[img], scope=scope)
    assert sorted(seen) == list(range(total))
    assert widths == [4]


def test_open_files_thread1_serial_path(tmp_path):
    paths, total = _write_shards(tmp_path, [2, 3])
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        reader = fluid.layers.open_files(
            paths, thread_num=1, shapes=[[-1, 3], [-1, 1]],
            lod_levels=[0, 0], dtypes=["float32", "int64"])
        img, lbl = fluid.layers.read_file(reader)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    seen = [int(exe.run(main, fetch_list=[lbl], scope=scope)[0]
                .reshape(-1)[0]) for _ in range(total)]
    assert seen == list(range(total))


def _graph(pkg, paths, place):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        r = pkg.layers.open_files(paths, thread_num=1,
                                  shapes=[[-1, 3], [-1, 1]],
                                  lod_levels=[0, 0],
                                  dtypes=["float32", "int64"])
        r = pkg.layers.create_shuffle_reader(r, buffer_size=4)
        r = pkg.layers.create_double_buffer_reader(r, place=place)
        r = pkg.layers.create_multi_pass_reader(r, pass_num=2)
        img, lbl = pkg.layers.read_file(r)
    return main, startup, img, lbl


def _pop_all(exe, main, scope, fetch, **kw):
    out = []
    while True:
        try:
            out.append(exe.run(main, fetch_list=fetch, scope=scope, **kw))
        except StopIteration:
            return out


def test_reader_graph_pops_the_reference_batches(tmp_path):
    """open_files -> shuffle -> double buffer on the CPU -> multi-pass(2)
    -> read_file built in both packages over one set of shards pops equal
    batches (the same shuffle seed), ends with StopIteration, and starts
    a new pass on the next run."""
    paths, total = _write_shards(tmp_path, [3, 4, 2])
    jmain, jstartup, jimg, jlbl = _graph(jfluid, paths, jfluid.CPUPlace())
    tmain, tstartup, timg, tlbl = _graph(fluid, paths, fluid.CPUPlace())
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace(), mode="eager"), \
        jfluid.Scope()
    texe, tscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    jexe.run(jstartup, scope=jscope)
    texe.run(tstartup, scope=tscope)
    random.seed(5)
    want = _pop_all(jexe, jmain, jscope, [jimg, jlbl],
                    use_program_cache=False)
    random.seed(5)
    got = _pop_all(texe, tmain, tscope, [timg, tlbl])
    assert len(got) == len(want) == 2 * total
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_array_equal(gl, np.asarray(wl))
        assert gi.dtype == np.float32 and gl.dtype == np.int64
    labels = [int(gl.reshape(-1)[0]) for _, gl in got]
    assert sorted(labels[:total]) == sorted(labels[total:]) == \
        list(range(total))
    # the next run starts a new pass
    iv, = texe.run(tmain, fetch_list=[timg], scope=tscope)
    assert iv.shape == (2, 3)


def test_reference_records_feed_the_port_graph(tmp_path):
    """Shards the JAX package wrote (pickle + its recordio) feed the
    port's reader graph."""
    paths, total = _write_shards(tmp_path, [2, 3], write=jwrite,
                                 enc=pickle.dumps)
    main, startup, img, lbl = _graph(fluid, paths, fluid.CPUPlace())
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    got = _pop_all(exe, main, scope, [lbl])
    assert sorted(int(v[0].reshape(-1)[0]) for v in got) == \
        sorted(list(range(total)) * 2)


# ---------------------------------------------------------------------------
# the executor's side of a reader graph
# ---------------------------------------------------------------------------

def _trainer(paths):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        r = fluid.layers.open_files(paths, thread_num=2,
                                    shapes=[[-1, 3], [-1, 1]],
                                    lod_levels=[0, 0],
                                    dtypes=["float32", "int64"])
        img, lbl = fluid.layers.read_file(r)
        loss = fluid.layers.mean(fluid.layers.fc(img, 2))
        fluid.optimizer.SGD(0.1).minimize(loss, startup)
    return main, startup, r, loss


def test_program_fed_by_a_read_op_alone(tmp_path):
    """A program whose only input is a read op: the reader var is a
    creator in the scope that the executor binds as it is (no move, cast
    or stack), the verifier takes it as a dataflow root, parameters are
    written back each step, and StopIteration leaves the scope as it was
    before that step."""
    paths, total = _write_shards(tmp_path, [3, 2])
    main, startup, r, loss = _trainer(paths)
    fluid.set_flags({"executor_verify": True})
    try:
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        creator = scope.find_var(r.name)
        assert callable(creator) and not torch.is_tensor(creator)
        assert scope.find_var(texec._RNG_KEY) is not None
        analysis = texec._analyze_program(main)
        assert r.name in analysis.free
        params = [p.name for p in main.global_block().all_parameters()]
        before = {n: scope.find_var(n).clone() for n in params}
        for _ in range(total):
            exe.run(main, fetch_list=[loss], scope=scope)
        assert analysis.verified
        assert scope.find_var(r.name) is creator
        moved = {n: scope.find_var(n).clone() for n in params}
        assert any(not torch.equal(before[n], moved[n]) for n in params)
        names = set(scope.local_names())
        with pytest.raises(StopIteration):
            exe.run(main, fetch_list=[loss], scope=scope)
        assert set(scope.local_names()) == names
        for n in params:
            assert torch.equal(scope.find_var(n), moved[n])
        exe.run(main, fetch_list=[loss], scope=scope)   # a new pass
    finally:
        fluid.set_flags({"executor_verify": False})


def test_reader_var_through_prepare_steps_is_left_alone(tmp_path):
    """prepare_steps stacks feeds only: a scope holding a reader creator
    beside the parameters runs prepared steps of a program fed by data."""
    paths, _ = _write_shards(tmp_path, [2])
    _, startup, r, _ = _trainer(paths)
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data("x", shape=[3])
        y = fluid.layers.scale(x, 2.0)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [{"x": np.full((2, 3), i, "float32")} for i in range(3)]
    out, = exe.run_steps(main, feeds, fetch_list=[y], scope=scope)
    np.testing.assert_array_equal(out[:, 0, 0], [0, 2, 4])
    assert callable(scope.find_var(r.name))


# ---------------------------------------------------------------------------
# the double buffer
# ---------------------------------------------------------------------------

def _feed_batches(n=5):
    rng = np.random.RandomState(6)
    return [{"img": rng.rand(2, 3).astype("float32"),
             "words": pack_sequences([rng.randint(0, 9, (k, 1))
                                      for k in (2, 4)]),
             "label": rng.randint(0, 2, (2, 1)).astype("int64")}
            for _ in range(n)]


def test_double_buffer_on_the_cpu_stages_batches_as_they_are():
    batches = _feed_batches()
    it = DeviceFeedIterator(lambda: iter(batches), place=fluid.CPUPlace(),
                            cast={"img": "float64"})
    got = list(it)
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        assert g["img"].dtype == torch.float64
        assert torch.equal(g["img"], torch.from_numpy(w["img"]).double())
        assert isinstance(g["words"], LoDArray)
        assert torch.equal(g["words"].data, w["words"].data)
        assert torch.equal(g["words"].lens, w["words"].lens)
        assert torch.equal(g["label"], torch.from_numpy(w["label"]))
    conv = double_buffer(lambda: iter(range(4)), place=fluid.CPUPlace(),
                         convert=lambda i: {"x": np.full((1,), i)})
    assert [int(b["x"][0]) for b in conv()] == [0, 1, 2, 3]


def test_double_buffer_feeder_error_reaches_the_consumer():
    def bad():
        yield {"x": np.zeros(2)}
        raise OSError("batch 2 unreadable")

    it = iter(DeviceFeedIterator(bad, place=fluid.CPUPlace()))
    next(it)
    with pytest.raises(OSError, match="unreadable"):
        next(it)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_double_buffer_default_place_is_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFeedIterator(lambda: iter(()))
