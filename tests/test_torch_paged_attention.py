"""The port's ragged paged-attention module against the reference's.

``ops/cuda/paged_attention.py``: the ``paged_attention`` decode op (plain
route, and the ``cuda`` tier whose wrapper runs its plain version on CPU
tensors) against the reference op under ``jnp`` and ``pallas`` on
tests/test_paged_attention_pallas.py's ``_case`` inputs; the wrapper and
its plain version against ``paged_attention_jnp`` and the interpret-mode
``paged_attention_pallas`` on the reference test's three ragged shapes;
the ``supported()`` edges; sentinel scatters. The kernel itself is held to
its plain version where a card is present (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops.pallas.paged_attention import (paged_attention_jnp,
                                                   paged_attention_pallas)
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import paged_attention as pak

# the reference test's own tolerance for kernel against twin: the online
# softmax re-associates the float32 sums
TOL = dict(atol=1e-5, rtol=1e-4)
# the reference's three ragged shapes (s, h, d, nb, bs, p)
SHAPES = [(4, 2, 8, 8, 4, 2), (8, 4, 16, 32, 8, 4), (2, 1, 4, 4, 2, 2)]


@pytest.fixture(autouse=True)
def _reset():
    ttier.reset_fallback_counts()
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})
    ttier.reset_fallback_counts()


def _case(seed=0, s=4, h=2, d=8, nb=8, bs=4, p=2, dtype=np.float32,
          ctx_lens=(7, 0, 8, 1)):
    """tests/test_paged_attention_pallas.py::_case's op inputs: one decode
    step, row 1 inactive (sentinel slot, ctx 0), ctx_lens counting the
    just-written token."""
    rng = np.random.RandomState(seed)
    e = h * d
    q = rng.normal(0, 1, (s, 1, e)).astype(dtype)
    k = rng.normal(0, 1, (s, 1, e)).astype(dtype)
    v = rng.normal(0, 1, (s, 1, e)).astype(dtype)
    kc = rng.normal(0, 1, (nb, bs, h, d)).astype(dtype)
    vc = rng.normal(0, 1, (nb, bs, h, d)).astype(dtype)
    bt = rng.randint(0, nb, (s, p)).astype(np.int32)
    cl = np.asarray(ctx_lens, np.int32)
    slots = np.where(cl > 0,
                     bt[np.arange(s), (cl - 1) // bs] * bs + (cl - 1) % bs,
                     nb * bs).astype(np.int32)
    return {"Q": q, "K": k, "V": v, "KCache": kc, "VCache": vc,
            "SlotMapping": slots, "BlockTables": bt, "ContextLens": cl}, h


def _run_op(fluid, place, op_type, inputs, out_slots, attrs):
    """One op in a fresh program; feeds COPIES of the inputs (the port's
    phase ops write the fed arena in place, and a CPU feed shares the
    numpy array's memory). Returns the fetches as numpy arrays."""
    main = fluid.Program()
    block = main.global_block()
    for name, arr in inputs.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                         is_data=True)
    for name in out_slots:
        block.create_var(name=name)
    block.append_op(op_type, {n: [n] for n in inputs},
                    {n: [n] for n in out_slots}, attrs)
    outs = fluid.Executor(place).run(
        main, feed={n: a.copy() for n, a in inputs.items()},
        fetch_list=list(out_slots), scope=fluid.Scope())
    return [np.asarray(o) for o in outs]


OUTS = ("Out", "KCacheOut", "VCacheOut")


def _both(inputs, h, routes):
    attrs = {"num_heads": h}
    jfluid.set_flags({"kernel_tier": routes[1]})
    want = _run_op(jfluid, jfluid.CPUPlace(), "paged_attention", inputs,
                   OUTS, attrs)
    tfluid.set_flags({"kernel_tier": routes[0]})
    got = _run_op(tfluid, tfluid.CPUPlace(), "paged_attention", inputs,
                  OUTS, attrs)
    return got, want


@pytest.mark.parametrize("routes", [("torch", "jnp"), ("cuda", "pallas"),
                                    ("cuda", "jnp")])
def test_decode_op_matches_reference_op(routes, monkeypatch):
    """Out within the kernel tolerance, the updated arenas bitwise, the
    inactive row exact zeros; the cuda tier calls the kernel wrapper once
    and routes nothing to the plain op chain."""
    calls = [0]
    real = pak.paged_attention_cuda

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(pak, "paged_attention_cuda", counted)
    inputs, h = _case()
    got, want = _both(inputs, h, routes)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert np.all(got[0][1] == 0.0)
    assert calls[0] == {"torch": 0, "cuda": 1}[routes[0]]
    assert ttier.fallback_counts() == {}


def test_float16_arena_routes_to_plain_version_counted():
    """A float16 arena has no kernel: under the cuda tier the op routes to
    the plain version with a fallback bump (the reference's pin, with its
    float16 tolerance)."""
    inputs, h = _case(dtype=np.float16)
    got, want = _both(inputs, h, ("cuda", "pallas"))
    assert ttier.fallback_counts() == {"paged_attention": 1}
    np.testing.assert_allclose(got[0].astype(np.float32),
                               want[0].astype(np.float32),
                               atol=5e-3, rtol=5e-2)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def _shape_case(seed, s, h, d, nb, bs, p):
    rng = np.random.RandomState(seed)
    qh = rng.normal(0, 1, (s, h, d)).astype(np.float32)
    kc = rng.normal(0, 1, (nb, bs, h, d)).astype(np.float32)
    vc = rng.normal(0, 1, (nb, bs, h, d)).astype(np.float32)
    bt = rng.randint(0, nb, (s, p)).astype(np.int32)
    cl = rng.randint(0, p * bs + 1, s).astype(np.int32)
    return qh, kc, vc, bt, cl


@pytest.mark.parametrize("case", range(len(SHAPES)))
@pytest.mark.parametrize("fn", ["paged_attention_cuda",
                                "paged_attention_torch"])
def test_wrapper_and_plain_version_match_reference_twins(case, fn):
    """The reference test's ragged shapes: against ``paged_attention_jnp``
    and the interpret-mode Pallas kernel at the reference's tolerance;
    inactive rows exact zeros."""
    arrs = _shape_case(case, *SHAPES[case])
    jargs = [jnp.asarray(a) for a in arrs]
    assert pak.paged_attention_supported(*[torch.from_numpy(arrs[i])
                                           for i in (0, 1, 3)])
    got = getattr(pak, fn)(*[torch.from_numpy(a) for a in arrs]).numpy()
    for ref in (paged_attention_jnp, paged_attention_pallas):
        np.testing.assert_allclose(got, np.asarray(ref(*jargs)), **TOL,
                                   err_msg=f"{fn} vs {ref.__name__}")
    assert np.all(got[arrs[4] == 0] == 0.0)


@pytest.mark.parametrize("qdt,kdt,kshape,d,want", [
    (torch.float32, torch.float32, (4, 4, 2, 8), 8, True),
    (torch.float16, torch.float32, (4, 4, 2, 8), 8, False),
    (torch.float32, torch.bfloat16, (4, 4, 2, 8), 8, False),
    (torch.float32, torch.float32, (2, 4096, 32, 128), 128, False),
    (torch.float32, torch.float32, (4, 4, 1, 256), 256, True),
    (torch.float32, torch.float32, (4, 4, 1, 264), 264, False),
])
def test_supported_predicate_edges(qdt, kdt, kshape, d, want):
    """The reference's edges (:117): float16 q, bfloat16 arena and a block
    past the 4 MiB budget route to the plain version; the card's own
    limit is a head dim of at most 256."""
    qh = torch.zeros((2, kshape[2], d), dtype=qdt)
    kc = torch.zeros(kshape, dtype=kdt)
    bt = torch.zeros((2, 2), dtype=torch.int32)
    assert pak.paged_attention_supported(qh, kc, bt) is want


def test_empty_table_is_unsupported():
    qh = torch.zeros((2, 2, 8))
    kc = torch.zeros((4, 4, 2, 8))
    assert not pak.paged_attention_supported(
        qh, kc, torch.zeros((2, 0), dtype=torch.int32))


@pytest.mark.parametrize("routes", [("torch", "jnp"), ("cuda", "pallas")])
def test_sentinel_scatter_writes_nothing(routes):
    """Every row idle (sentinel slots, ctx 0): the arenas come back bitwise
    unchanged and Out is zeros, as in the reference."""
    inputs, h = _case(ctx_lens=(0, 0, 0, 0))
    assert np.all(inputs["SlotMapping"] == 8 * 4)
    got, want = _both(inputs, h, routes)
    np.testing.assert_array_equal(got[1], inputs["KCache"])
    np.testing.assert_array_equal(got[2], inputs["VCache"])
    np.testing.assert_array_equal(got[1], want[1])
    assert np.all(got[0] == 0.0) and np.all(want[0] == 0.0)


def test_live_slot_writes_its_row_in_place():
    """The decode op writes the new K/V row at its slot into the fed arena
    tensor itself (in place), and only there."""
    inputs, h = _case()
    kc = torch.from_numpy(inputs["KCache"].copy())
    main = tfluid.Program()
    block = main.global_block()
    for name, arr in inputs.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                         is_data=True)
    for name in OUTS:
        block.create_var(name=name)
    block.append_op("paged_attention", {n: [n] for n in inputs},
                    {n: [n] for n in OUTS}, {"num_heads": h})
    feed = {n: a.copy() for n, a in inputs.items()}
    feed["KCache"] = kc
    out = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=["KCacheOut"], scope=tfluid.Scope(),
        return_numpy=False)[0]
    assert out is kc
    flat = kc.reshape(-1, 2, 8).numpy()
    before = inputs["KCache"].reshape(-1, 2, 8)
    live = inputs["SlotMapping"] < 32
    written = inputs["SlotMapping"][live]
    np.testing.assert_array_equal(
        flat[written], inputs["K"].reshape(4, 2, 8)[live])
    rest = np.setdiff1d(np.arange(32), written)
    np.testing.assert_array_equal(flat[rest], before[rest])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would build and "
                    "run")
    meta = dict(device="meta")
    qh = torch.empty((2, 2, 8), **meta)
    kc = torch.empty((4, 4, 2, 8), **meta)
    bt = torch.empty((2, 2), dtype=torch.int32, **meta)
    cl = torch.empty((2,), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="int32"):
        pak.paged_attention_cuda(qh, kc, kc, bt.long(), cl)
    with pytest.raises(ValueError, match="float32"):
        pak.paged_attention_cuda(qh.half(), kc, kc, bt, cl)
    with pytest.raises(ValueError, match="arenas"):
        pak.paged_attention_cuda(qh, kc, torch.empty((4, 4, 2, 4), **meta),
                                 bt, cl)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_paged_attention.py on the GPU "
                    "machine)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(8, 4, 32, 256, 8, 16),
                                            (3, 2, 256, 16, 4, 3),
                                            (5, 3, 40, 12, 5, 4)])
def test_kernel_matches_plain_version_on_card(shape):
    """The kernel at the reference's shapes, the serving lane's (D 32) and
    odd head dims, against its plain version at the reference tolerance:
    one launch a call, inactive rows exact zeros."""
    _need_card()
    arrs = _shape_case(7, *shape)
    qh, kc, vc, bt, cl = [torch.from_numpy(a).cuda() for a in arrs]
    cl[0] = 0
    cl[-1] = bt.shape[1] * kc.shape[1]
    want = pak.paged_attention_torch(qh, kc, vc, bt, cl)
    before = pak.launches["paged_attention"]
    got = pak.paged_attention_cuda(qh, kc, vc, bt, cl)
    torch.cuda.synchronize()
    assert pak.launches["paged_attention"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.all(got[cl == 0] == 0)


# the split model's cases: (s, h, d, nb, bs, p, part) with P·bs spanning 1,
# 2 and 5 partitions of ``part`` positions, and lengths 1, on a partition
# boundary, P·bs, idle, and short enough that later partitions lie wholly
# past them
SPLIT_SHAPES = [(6, 2, 8, 12, 4, 2, 8), (6, 2, 8, 16, 4, 4, 8),
                (6, 3, 12, 40, 4, 10, 8), (6, 1, 5, 24, 2, 10, 4)]


def _split_case(seed, s, h, d, nb, bs, p, part):
    arrs = list(_shape_case(seed, s, h, d, nb, bs, p))
    c = p * bs
    arrs[4] = np.minimum(np.array([1, part, 2 * part, c, 0, 3]), c) \
        .astype(np.int32)[:s]
    return arrs


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("fn", ["split", "paged_attention_cuda"])
def test_split_model_and_wrapper_match_reference_twins(shape, fn):
    """The kernel's decomposition (per-partition max, normalizer and
    weighted sum, merged in partition order) and the wrapper's CPU route
    against ``paged_attention_jnp`` and the interpret-mode Pallas kernel at
    the reference's tolerance; idle rows exact zeros."""
    arrs = _split_case(3, *shape)
    part = shape[-1]
    targs = [torch.from_numpy(a) for a in arrs]
    if fn == "split":
        got = pak.paged_attention_split_torch(*targs, part).numpy()
    else:
        got = pak.paged_attention_cuda(*targs).numpy()
    jargs = [jnp.asarray(a) for a in arrs]
    for ref in (paged_attention_jnp, paged_attention_pallas):
        np.testing.assert_allclose(got, np.asarray(ref(*jargs)), **TOL,
                                   err_msg=f"{fn} vs {ref.__name__}")
    assert np.all(got[arrs[4] == 0] == 0.0)


@pytest.mark.parametrize("part", [1, 3, 8, 1000])
def test_split_model_matches_plain_version_at_any_partition(part):
    """Any partition size gives the plain version's result to float32
    roundings, a partition of one position and one past the table too."""
    arrs = _split_case(4, 6, 2, 8, 16, 4, 4, 8)
    targs = [torch.from_numpy(a) for a in arrs]
    np.testing.assert_allclose(
        pak.paged_attention_split_torch(*targs, part).numpy(),
        pak.paged_attention_torch(*targs).numpy(), **TOL)


@pytest.mark.parametrize("p, bs, want", [
    (16, 8, 1),        # the serving lane's tables: the single-pass path
    (256, 16, 16),     # Llama-2-7B's 4096 positions in blocks of 16
    (1, 1, 1), (257, 1, 2), (3, 1024, 3), (33, 8, 2)])
def test_nsplit_is_a_function_of_the_static_shapes(p, bs, want):
    """The wrapper's partition count from (P, block_size) alone, no
    lengths: ceil(P / part_blocks) with part_blocks = PART // bs whole
    blocks (at least one)."""
    assert pak.PART == 256
    assert pak.paged_attention_nsplit(p, bs) == want
    assert pak.part_blocks(bs) == max(1, 256 // bs)


def _card_case(seed, s, h, d, bs, p, lens, spare=8):
    """Tensors on the card: a fragmented arena of the slots' blocks plus
    ``spare``, tables padded with block 0, lengths ``lens``."""
    rng = np.random.RandomState(seed)
    lens = np.asarray(lens, np.int64)
    nblk = -(-lens // bs)
    nb = int(nblk.sum()) + spare
    perm = rng.permutation(nb)
    bt = np.zeros((s, p), np.int32)
    o = 0
    for i in range(s):
        bt[i, :nblk[i]] = perm[o:o + nblk[i]]
        o += nblk[i]
    arrs = [rng.normal(0, 1, (s, h, d)), rng.normal(0, 1, (nb, bs, h, d)),
            rng.normal(0, 1, (nb, bs, h, d))]
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrs] \
        + [torch.from_numpy(bt).cuda(),
           torch.from_numpy(lens.astype(np.int32)).cuda()]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 33, 40])
def test_split_path_matches_plain_version_on_card(d):
    """The split path (4096 positions in blocks of 16: nsplit 16) at D 128
    and odd head dims (scalar and float4 loads), contexts up to 4096 with
    lengths on and off partition boundaries and an idle slot, against the
    plain version at the reference tolerance; one wrapper launch a call."""
    _need_card()
    bs, p = 16, 256
    assert pak.paged_attention_nsplit(p, bs) > 1
    part = pak.part_blocks(bs) * bs
    lens = [4096, 1, part, part + 1, 3 * part - 1, 0, 2500, 4095]
    args = _card_case(21, len(lens), 4, d, bs, p, lens)
    want = pak.paged_attention_torch(*args)
    before = pak.launches["paged_attention"]
    got = pak.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    assert pak.launches["paged_attention"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.all(got[args[4] == 0] == 0)


@pytest.mark.cuda
def test_slot_output_independent_of_the_batch_on_card():
    """Slot 0's output is the same bits when the other slots' queries,
    lengths and tables change, when the batch grows, and on a repeat call:
    no sum depends on another slot or on the order CTAs finish."""
    _need_card()
    bs, p = 16, 256
    lens = [3001, 17, 4096, 0, 600]
    a = _card_case(22, len(lens), 4, 128, bs, p, lens)
    first = pak.paged_attention_cuda(*a)
    again = pak.paged_attention_cuda(*a)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    b = [t.clone() for t in a]
    b[0][1:] = torch.randn_like(b[0][1:])
    b[4][1:] = torch.tensor([4096, 1, 2048, 5], dtype=torch.int32,
                            device="cuda")
    b[3][1:] = torch.flip(b[3][1:], dims=(0,))
    other = pak.paged_attention_cuda(*b)
    grown = pak.paged_attention_cuda(
        torch.cat([a[0], a[0]]), a[1], a[2], torch.cat([a[3], a[3]]),
        torch.cat([a[4], a[4].flip(0)]))
    torch.cuda.synchronize()
    assert torch.equal(other[0], first[0])
    assert torch.equal(grown[0], first[0])
