"""The port's momentum arena kernel module against the reference's.

``momentum_arena`` on CPU tensors runs its plain version,
``momentum_arena_torch``, the per-parameter expression. It is held against
the reference's ``momentum_arena_pallas`` run in interpret mode over
parameters of odd sizes (none a multiple of the reference's 1024-element
tile), with nesterov off and on. The kernel itself is checked bitwise
against the plain version where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import optimizer as jax_opk
from paddle_tpu_torch.ops.cuda import optimizer as opk

SHAPES = [(3, 5), (1037,), (7, 3, 3, 2), (1,), (2049,)]
LR, MU = 0.05, 0.9
# both apply the same float32 multiply and add per element; XLA on the CPU
# may contract v·mu + g into one fused multiply-add, which rounds once
# instead of twice: one float32 step of the result
TOL = dict(rtol=2e-7, atol=1e-7)


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return [[rng.normal(0, 1, s).astype("float32") for s in SHAPES]
            for _ in range(3)]


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_arena_matches_pallas(nesterov):
    ps, gs, vs = _state()
    arenas = [jax_opk.flatten_arena([jnp.asarray(a) for a in xs])[0]
              for xs in (ps, gs, vs)]
    p_out, v_out = jax_opk.momentum_arena_pallas(*arenas, LR, MU,
                                                 nesterov=nesterov)
    want_p = jax_opk.split_arena(p_out, SHAPES)
    want_v = jax_opk.split_arena(v_out, SHAPES)
    t = [[torch.from_numpy(a.copy()) for a in xs] for xs in (ps, gs, vs)]
    got_p, got_v = opk.momentum_arena(*t, torch.tensor(LR), MU, nesterov)
    assert opk.launches["momentum_arena"] == 0
    for g, w in zip(got_p + got_v, want_p + want_v):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_plain_version_is_the_per_parameter_expression():
    """The plain version is bitwise the per-parameter momentum op's
    expression, which is what keeps a fused_momentum program bitwise equal
    to the per-parameter one under kernel_tier=torch."""
    ps, gs, vs = ([torch.from_numpy(a) for a in xs] for xs in _state(1))
    lr = torch.tensor(LR)
    got_p, got_v = opk.momentum_arena_torch(ps, gs, vs, lr, MU, True)
    for p, g, v, gp, gv in zip(ps, gs, vs, got_p, got_v):
        v_new = MU * v + g
        assert torch.equal(gv, v_new)
        assert torch.equal(gp, p - (g + MU * v_new) * lr)


def test_arena_wrapper_rejects_what_the_kernel_does_not_take():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would build and run")
    with pytest.raises(ValueError, match="non-empty"):
        opk.momentum_arena([], [], [], torch.tensor(LR), MU, False)
    p = torch.empty((4,), device="meta")
    g = torch.empty((4,), device="meta", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        opk.momentum_arena([p], [g], [p], torch.empty((), device="meta"),
                           MU, False)


@pytest.mark.cuda
@pytest.mark.parametrize("nesterov", [False, True])
def test_kernel_is_bitwise_the_plain_version_on_card(nesterov):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_optimizer_arena.py on the GPU machine)")
    ps, gs, vs = ([torch.from_numpy(a).cuda() for a in xs]
                  for xs in _state(2))
    lr = torch.tensor(LR, device="cuda")
    want_p, want_v = opk.momentum_arena_torch(ps, gs, vs, lr, MU, nesterov)
    before = opk.launches["momentum_arena"]
    got_p, got_v = opk.momentum_arena([p.clone() for p in ps], gs,
                                      [v.clone() for v in vs], lr, MU,
                                      nesterov)
    torch.cuda.synchronize()
    assert opk.launches["momentum_arena"] == before + 1
    for g, w in zip(got_p + got_v, want_p + want_v):
        assert torch.equal(g, w)


def test_fused_momentum_sends_the_float32_set_to_the_arena(monkeypatch):
    """Under a kernel tier fused_momentum hands its float32 parameters to
    the arena wrapper in one call and gives the rest the per-parameter
    expression; every result lands under its own parameter's name,
    bitwise the per-parameter expression."""
    import paddle_tpu_torch.fluid as tfluid
    seen = []
    real = opk.momentum_arena

    def spy(ps, *args):
        seen.append([tuple(p.shape) for p in ps])
        return real(ps, *args)

    monkeypatch.setattr(opk, "momentum_arena", spy)
    rng = np.random.RandomState(3)
    dtypes = ("float32", "float64", "float32")
    feeds = {"lr": np.array([LR], "float32")}
    for i, (shape, dtype) in enumerate(zip(SHAPES, dtypes)):
        for k in "pgv":
            feeds[f"{k}{i}"] = rng.normal(0, 1, shape).astype(dtype)
    prog = tfluid.Program()
    block = prog.global_block()
    for name, arr in feeds.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
    ps, gs, vs = ([f"{k}{i}" for i in range(len(dtypes))] for k in "pgv")
    block.append_op("fused_momentum",
                    inputs={"Params": ps, "Grads": gs, "Velocities": vs,
                            "LearningRate": ["lr"]},
                    outputs={"ParamsOut": ps, "VelocitiesOut": vs},
                    attrs={"mu": MU, "use_nesterov": False})
    tfluid.set_flags({"kernel_tier": "cuda"})
    try:
        out = tfluid.Executor(tfluid.CPUPlace()).run(
            prog, feed=feeds, fetch_list=ps + vs, scope=tfluid.Scope())
    finally:
        tfluid.set_flags({"kernel_tier": "auto"})
    assert seen == [[SHAPES[0], SHAPES[2]]]
    lr = torch.tensor(LR).reshape(())
    for i in range(len(dtypes)):
        p, g, v = (torch.from_numpy(feeds[f"{k}{i}"]) for k in "pgv")
        want_p, want_v = opk._momentum_dense(p, g, v, lr, MU, False)
        assert out[i].dtype == np.dtype(dtypes[i])
        np.testing.assert_array_equal(out[i], want_p.numpy())
        np.testing.assert_array_equal(out[len(dtypes) + i], want_v.numpy())


def test_pack_table_rows_and_chunk_prefix():
    """Columns (pointers..., numels, first chunks) from fake pointers, the
    first chunks the prefix of each parameter's CHUNK pieces; an empty
    parameter takes none."""
    c = opk._CHUNK
    numels = [15, c, c + 1, 0, 2 * c]
    ps, gs, vs = ([base + i for i in range(5)] for base in (1000, 2000, 3000))
    [(table, rows, chunks)] = opk.pack_table([ps, gs], numels, 5)
    assert (rows, chunks) == (5, 1 + 1 + 2 + 0 + 2)
    assert table.itemsize == 8 and table.typecode == "q"
    assert list(table) == [1000, 1001, 1002, 1003, 1004,
                           2000, 2001, 2002, 2003, 2004,
                           15, c, c + 1, 0, 2 * c,
                           0, 1, 2, 4, 4]
    [(table, rows, chunks)] = opk.pack_table([ps, gs, vs], numels, 1000)
    assert (rows, chunks) == (5, 6)
    assert list(table[10:]) == [3000, 3001, 3002, 3003, 3004,
                                15, c, c + 1, 0, 2 * c, 0, 1, 2, 4, 4]


@pytest.mark.parametrize("rows", [4, 31, 161])
def test_pack_table_layout_at_word2vec_to_resnet50_lengths(rows):
    """At a list as short as word2vec's and as long as ResNet-50's, the
    table is the columns hand-computed here one parameter at a time."""
    c = opk._CHUNK
    rng = np.random.RandomState(rows)
    numels = rng.choice([0, 1, c - 1, c, c + 1, 5 * c + 7], rows).tolist()
    cols = [[(k + 1) * 10 ** 9 + 256 * i for i in range(rows)]
            for k in range(3)]
    firsts, first = [], 0
    for n in numels:
        firsts.append(first)
        first += -(-n // c)
    [(table, got_rows, chunks)] = opk.pack_table(cols, numels, rows)
    assert (got_rows, chunks) == (rows, first)
    assert list(table) == cols[0] + cols[1] + cols[2] + numels + firsts


@pytest.mark.parametrize("bad", ["float16", "shape", "device", "strided"])
def test_gather_rejects_in_the_same_pass(bad):
    """Every param, grad and state tensor is checked; the pointers and
    sizes of a good list come back column by column."""
    ps = [torch.zeros(7), torch.zeros(3, 5)]
    gs = [torch.ones(7), torch.ones(3, 5)]
    cpu = torch.device("cpu")
    cols, numels = opk._gather("sgd_arena", [ps, gs], cpu)
    assert cols == [[t.data_ptr() for t in ps], [t.data_ptr() for t in gs]]
    assert numels == [7, 15]
    if bad == "device":
        # CPU tensors against a card's device
        cpu = torch.device("cuda", 0)
    else:
        gs[1] = {"float16": torch.ones(3, 5, dtype=torch.float16),
                 "shape": torch.ones(5, 3),
                 "strided": torch.ones(5, 3).t()}[bad]
    with pytest.raises(ValueError, match="contiguous float32"):
        opk._gather("sgd_arena", [ps, gs], cpu)


@pytest.mark.parametrize("limit, want", [
    (10 ** 6, [(5, 7)]),
    (3 * 32, [(3, 4), (2, 3)]),
    (2 * 32 + 31, [(2, 2), (2, 3), (1, 2)]),
    (32, [(1, 1), (1, 1), (1, 2), (1, 1), (1, 2)]),
])
def test_split_table_at_a_byte_limit(limit, want):
    """Each launch holds the rows its parameter space fits (32 bytes an SGD
    row): the list's next rows, its first chunks counting from 0 and its
    chunk count its own."""
    c = opk._CHUNK
    numels = [5, c, c + 1, c, 2 * c]
    parts = opk.pack_table([[100 + i for i in range(5)],
                            [200 + i for i in range(5)]], numels, limit // 32)
    assert [(n, nch) for _, n, nch in parts] == want
    r0 = 0
    for table, n, nch in parts:
        rows = range(r0, r0 + n)
        firsts = list(table[3 * n:])
        assert list(table[:3 * n]) == [100 + r for r in rows] \
            + [200 + r for r in rows] + [numels[r] for r in rows]
        assert firsts[0] == 0
        ends = firsts[1:] + [nch]
        assert [e - f for f, e in zip(firsts, ends)] == \
            [-(-numels[r] // c) for r in rows]
        r0 += n
    assert r0 == len(numels)


def _resnet50_shapes():
    """ResNet-50's trainable parameter shapes as bench.py builds it (161
    tensors, 25 557 032 elements after fuse_conv_bn)."""
    import paddle_tpu_torch.fluid as tfluid
    from paddle_tpu_torch.testing.models import resnet
    tfluid.reset_unique_name()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.layers.data("img", shape=[224, 224, 3])
        label = tfluid.layers.data("label", shape=[1], dtype="int64")
        loss = tfluid.layers.mean(tfluid.layers.softmax_with_cross_entropy(
            resnet(img, 1000), label))
        tfluid.fuse_conv_bn(main)
        tfluid.optimizer.SGD(0.1, fused=True).minimize(loss, startup)
    return [tuple(p.shape) for p in main.global_block().all_parameters()
            if p.trainable]


def _sgd_on_card(shapes, seed, views=None):
    """sgd_arena against its plain version over tensors of ``shapes``
    (``views(i, shape)`` may give a tensor another base), bitwise; returns
    the launches it took."""
    rng = np.random.RandomState(seed)

    def make(i, s):
        a = torch.from_numpy(rng.normal(0, 1, s).astype("float32")).cuda()
        return views(i, a) if views else a

    ps = [make(i, s) for i, s in enumerate(shapes)]
    gs = [make(i, s) for i, s in enumerate(shapes)]
    lr = torch.tensor([0.05], device="cuda")
    want = opk.sgd_arena_torch(ps, gs, lr)
    before = opk.launches["sgd_arena"]
    got = opk.sgd_arena([p.clone() if not views else views(0, p.clone())
                         for p in ps], gs, lr)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return opk.launches["sgd_arena"] - before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_optimizer_arena.py on the GPU machine)")


@pytest.mark.cuda
def test_sgd_arena_resnet50_set_is_bitwise_on_card():
    _need_card()
    shapes = _resnet50_shapes()
    assert len(shapes) == 161
    assert sum(int(np.prod(s)) for s in shapes) == 25_557_032
    assert _sgd_on_card(shapes, 11) == 1


@pytest.mark.cuda
def test_sgd_arena_odd_sizes_and_unaligned_views_on_card():
    """Sizes that are no multiple of 4, and views whose base is not 16-byte
    aligned: p and g offset alike (a scalar head, then float4s) and p
    offset alone (scalar throughout)."""
    _need_card()
    shapes = [(1,), (3,), (5, 7), (4097,), (8191,), (3, 3, 3, 3), (4096,),
              (12289,)]
    assert _sgd_on_card(shapes, 12) == 1

    def shifted(i, a):
        # copy a into a buffer at a 1-element (4-byte) offset
        buf = torch.empty(a.numel() + 3, device=a.device)
        v = buf[1:1 + a.numel()].view(a.shape)
        v.copy_(a)
        assert v.data_ptr() % 16 == 4
        return v

    assert _sgd_on_card(shapes, 13, shifted) == 1
    rng = np.random.RandomState(14)
    ps = [torch.from_numpy(rng.normal(0, 1, s).astype("float32")).cuda()
          for s in shapes]
    gs = [shifted(0, torch.from_numpy(rng.normal(0, 1, s).astype("float32"))
                  .cuda()) for s in shapes]
    lr = torch.tensor([0.05], device="cuda")
    want = opk.sgd_arena_torch(ps, gs, lr)
    got = opk.sgd_arena([p.clone() for p in ps], gs, lr)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_arena_list_past_one_table_takes_more_launches_on_card():
    """A list longer than one launch's parameter-space table: as many
    launches as tables, bitwise."""
    _need_card()
    n = opk._max_rows(4) + 7
    shapes = [(1 + i % 37,) for i in range(n)]
    assert _sgd_on_card(shapes, 15) == 2
    rng = np.random.RandomState(16)
    m = opk._max_rows(5) + 3
    ps, gs, vs = ([torch.from_numpy(rng.normal(0, 1, (1 + i % 29,))
                                    .astype("float32")).cuda()
                   for i in range(m)] for _ in range(3))
    lr = torch.tensor(LR, device="cuda")
    want_p, want_v = opk.momentum_arena_torch(ps, gs, vs, lr, MU, False)
    before = opk.launches["momentum_arena"]
    got_p, got_v = opk.momentum_arena([p.clone() for p in ps], gs,
                                      [v.clone() for v in vs], lr, MU, False)
    torch.cuda.synchronize()
    assert opk.launches["momentum_arena"] == before + 2
    for g, w in zip(got_p + got_v, want_p + want_v):
        assert torch.equal(g, w)


def ROWS(width):
    """A launch's rows for the kept-table tests: all of a short list."""
    return 100


def _cpu_lists(seed=5, shapes=((7,), (3, 5), (4, 4))):
    rng = np.random.RandomState(seed)
    return [[torch.from_numpy(rng.normal(0, 1, s).astype("float32"))
             for s in shapes] for _ in range(3)]


def _columns(table, n):
    return [list(table[k * n:(k + 1) * n]) for k in range(len(table) // n)]


@pytest.fixture
def packed():
    opk._PACKED.clear()
    opk.reset_launches()
    yield
    opk._PACKED.clear()
    opk.reset_launches()


def test_kept_tables_refill_only_the_grads(packed):
    """The same params and velocities come back: packed once; each call's
    grads fill their column, the rest of the table as packed."""
    ps, gs, vs = _cpu_lists()
    cpu = torch.device("cpu")
    [(t1, n, c)] = opk._tables("momentum_arena", ps, gs, [vs], cpu, ROWS)
    want = _columns(t1, n)
    gs2 = [g.clone() for g in gs]
    [(t2, _, c2)] = opk._tables("momentum_arena", list(ps), gs2, [list(vs)],
                                cpu, ROWS)
    assert opk.packs["momentum_arena"] == 1 and c2 == c
    got = _columns(t2, n)
    assert got[1] == [g.data_ptr() for g in gs2]
    assert got[:1] + got[2:] == want[:1] + want[2:]
    cols, numels = opk._gather("momentum_arena", [ps, gs2, vs], cpu)
    assert got == cols + [numels, want[-1]]


@pytest.mark.parametrize("swap", ["view", "strided", "float16", "moved",
                                  "grad_view", "grad_strided", "shorter"])
def test_kept_tables_never_serve_a_replaced_tensor(packed, swap):
    """A kept list whose tensor is swapped for a view of another shape, a
    strided or float16 tensor, or moved to new storage in place, and grads
    of another shape or layout, repack or raise the wrapper's ValueError:
    never the stale table."""
    ps, gs, vs = _cpu_lists()
    cpu = torch.device("cpu")
    opk._tables("momentum_arena", ps, gs, [vs], cpu, ROWS)
    ps, gs, vs = list(ps), list(gs), list(vs)
    raises = True
    if swap == "view":
        # the same storage as another shape; with grads of that shape the
        # list repacks
        ps[1] = ps[1].view(5, 3)
        vs[1] = vs[1].view(5, 3)
        gs[1] = gs[1].view(5, 3)
        raises = False
    elif swap == "strided":
        ps[2] = ps[2].t()
        gs[2] = gs[2].t().contiguous()
        vs[2] = vs[2].t().contiguous()
    elif swap == "float16":
        vs[0] = vs[0].half()
    elif swap == "moved":
        ps[0].set_(torch.zeros(7))
        raises = False
    elif swap == "grad_view":
        gs[1] = gs[1].view(5, 3)
    elif swap == "grad_strided":
        gs[2] = gs[2].t()
    elif swap == "shorter":
        ps, gs, vs = ps[:2], gs[:2], vs[:2]
        raises = False
    if raises:
        with pytest.raises(ValueError, match="contiguous float32"):
            opk._tables("momentum_arena", ps, gs, [vs], cpu, ROWS)
        return
    [(table, n, c)] = opk._tables("momentum_arena", ps, gs, [vs], cpu, ROWS)
    assert opk.packs["momentum_arena"] == 2
    cols, numels = opk._gather("momentum_arena", [ps, gs, vs], cpu)
    assert _columns(table, n)[:-1] == cols + [numels]


@pytest.mark.parametrize("bad", ["float16", "shape", "device", "strided"])
def test_kept_tables_reject_in_the_same_pass(packed, bad):
    """After a list is kept, every bad grad or state still raises the
    wrapper's ValueError (the cases of test_gather_rejects_in_the_same_pass,
    through the kept tables)."""
    ps, gs, vs = _cpu_lists()
    cpu = torch.device("cpu")
    opk._tables("sgd_arena", ps, gs, [], cpu, ROWS)
    opk._tables("sgd_arena", ps, gs, [], cpu, ROWS)
    assert opk.packs["sgd_arena"] == 1
    if bad == "device":
        cpu = torch.device("cuda", 0)
    else:
        gs = list(gs)
        gs[1] = {"float16": torch.ones(3, 5, dtype=torch.float16),
                 "shape": torch.ones(5, 3),
                 "strided": torch.ones(5, 3).t()}[bad]
    with pytest.raises(ValueError, match="contiguous float32"):
        opk._tables("sgd_arena", ps, gs, [], cpu, ROWS)


def test_kept_tables_hold_no_reference(packed):
    """A freed parameter list leaves nothing alive behind: the kept table
    holds weak references, and a new list of the same length repacks."""
    import gc
    import weakref
    ps, gs, vs = _cpu_lists()
    cpu = torch.device("cpu")
    opk._tables("momentum_arena", ps, gs, [vs], cpu, ROWS)
    refs = [weakref.ref(t) for t in ps + vs]
    del ps, vs
    gc.collect()
    assert all(r() is None for r in refs)
    ps2, _, vs2 = _cpu_lists(6)
    opk._tables("momentum_arena", ps2, gs, [vs2], cpu, ROWS)
    assert opk.packs["momentum_arena"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_arena_odd_sizes_and_unaligned_views_on_card(nesterov):
    """momentum_arena bitwise its plain version at sizes that are no
    multiple of 4 and on views whose base is not 16-byte aligned: p, g
    and v offset alike (a scalar head, then float4s) and g offset alone
    (scalar throughout); one launch each."""
    _need_card()
    shapes = [(1,), (3,), (5, 7), (4097,), (8191,), (3, 3, 3, 3), (4096,),
              (12289,)]

    def shifted(a):
        buf = torch.empty(a.numel() + 3, device=a.device)
        v = buf[1:1 + a.numel()].view(a.shape)
        v.copy_(a)
        assert v.data_ptr() % 16 == 4
        return v

    lr = torch.tensor(LR, device="cuda")
    for seed, (fp, fg, fv) in enumerate([(None, None, None),
                                         (shifted, shifted, shifted),
                                         (None, shifted, None)]):
        rng = np.random.RandomState(30 + seed)
        ps, gs, vs = ([torch.from_numpy(rng.normal(0, 1, s)
                                        .astype("float32")).cuda()
                       for s in shapes] for _ in range(3))
        keep = lambda f, t: f(t) if f else t  # noqa: E731
        gs = [keep(fg, g) for g in gs]
        want_p, want_v = opk.momentum_arena_torch(ps, gs, vs, lr, MU,
                                                  nesterov)
        before = opk.launches["momentum_arena"]
        got_p, got_v = opk.momentum_arena(
            [keep(fp, p.clone()) for p in ps], gs,
            [keep(fv, v.clone()) for v in vs], lr, MU, nesterov)
        torch.cuda.synchronize()
        assert opk.launches["momentum_arena"] == before + 1
        for g, w in zip(got_p + got_v, want_p + want_v):
            assert torch.equal(g, w)
