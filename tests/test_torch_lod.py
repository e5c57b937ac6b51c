"""The port's LoD (ragged-sequence) support against the reference's.

The LoDArray helpers, the executor's three LoD feed forms and its LoD
fetch, and the text classifier's LoD-transparent and sequence ops, each
run as a one-op program in each package on the same seeded numpy inputs
(LoD inputs as padded data plus lengths), on the CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import lod as jlod
from paddle_tpu_torch.core import lod as tlod

# float32 elementwise work and short sums: both packages round the same
# float32 operations, up to sums taken in another order (XLA vs PyTorch's
# CPU kernels), a few float32 steps of the largest term
TOL = dict(rtol=1e-5, atol=1e-6)
LENS = np.array([5, 2, 0, 3], np.int32)


@pytest.fixture(autouse=True)
def _tiers():
    jfluid.set_flags({"kernel_tier": "jnp"})
    tfluid.set_flags({"kernel_tier": "torch"})
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


class Lod:
    """A LoD feed for both packages: padded numpy data and lengths."""

    def __init__(self, data, lens=LENS):
        self.data, self.lens = data, np.asarray(lens, np.int32)

    def for_package(self, fluid):
        if fluid is jfluid:
            return jlod.LoDArray(self.data, self.lens)
        return tlod.LoDArray(torch.from_numpy(self.data),
                             torch.from_numpy(self.lens))


def _padded(rng, *feat, lens=LENS, scale=1.0, dtype="float32"):
    """[b, max_len, *feat] data, zero past each row's length."""
    data = rng.normal(0, scale, (len(lens), int(max(lens))) + feat)
    mask = np.arange(data.shape[1])[None, :] < np.asarray(lens)[:, None]
    return (data * mask.reshape(mask.shape + (1,) * len(feat))).astype(dtype)


def _value(v):
    """(data, lens) of a fetched LoDArray, or (array, None)."""
    if isinstance(v, (jlod.LoDArray, tlod.LoDArray)):
        return np.asarray(v.data), np.asarray(v.lens)
    return np.asarray(v), None


def _run_op(fluid, op_type, inputs, outputs, attrs, feeds):
    prog = fluid.Program()
    block = prog.global_block()
    feed = {}
    for name, v in feeds.items():
        if isinstance(v, Lod):
            block.create_var(name=name, shape=v.data.shape[:1]
                             + v.data.shape[2:], dtype=str(v.data.dtype),
                             lod_level=1)
            feed[name] = v.for_package(fluid)
        else:
            block.create_var(name=name, shape=v.shape, dtype=str(v.dtype))
            feed[name] = v
    fetch = [n for names in outputs.values() for n in names]
    for n in fetch:
        if not block.has_var(n):
            block.create_var(name=n)
    block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    exe = fluid.Executor(fluid.CPUPlace())
    return [_value(v) for v in exe.run(prog, feed=feed, fetch_list=fetch,
                                       scope=fluid.Scope())]


def _both(op_type, inputs, outputs, attrs, feeds, tol=TOL):
    """Run the op in both packages; every output (and a LoD output's
    lengths) must agree. Returns the port's outputs as feeds for the next
    op: a Lod where the output carries lengths."""
    want = _run_op(jfluid, op_type, inputs, outputs, attrs, feeds)
    got = _run_op(tfluid, op_type, inputs, outputs, attrs, feeds)
    names = [n for ns in outputs.values() for n in ns]
    out = []
    for name, (g, gl), (w, wl) in zip(names, got, want):
        assert g.shape == w.shape, (op_type, name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{op_type} {name}")
        assert (gl is None) == (wl is None), (op_type, name)
        if gl is not None:
            np.testing.assert_array_equal(gl, wl)
        out.append(g if gl is None else Lod(g, gl))
    return out


def test_lodarray_mask_and_pack_sequences():
    rng = np.random.RandomState(0)
    seqs = [rng.normal(0, 1, (n, 3)).astype("float32") for n in LENS]
    for kw in ({}, {"pad_multiple": 4}, {"max_len": 7}):
        want = jlod.pack_sequences(seqs, **kw)
        got = tlod.pack_sequences(seqs, **kw)
        np.testing.assert_array_equal(got.data.numpy(), want.data)
        np.testing.assert_array_equal(got.lens.numpy(), want.lens)
        np.testing.assert_array_equal(got.mask().numpy(),
                                      np.asarray(want.mask()))
        assert (got.batch, got.max_len) == (want.batch, want.max_len)


def test_flat_and_lodarray_round_trip():
    rng = np.random.RandomState(1)
    flat = rng.normal(0, 1, (int(LENS.sum()), 2)).astype("float32")
    lod = jlod.lod_from_lens(LENS)
    assert tlod.lod_from_lens(LENS) == lod
    np.testing.assert_array_equal(tlod.lens_from_lod(lod),
                                  jlod.lens_from_lod(lod))
    got = tlod.flat_to_lodarray(flat, lod)
    want = jlod.flat_to_lodarray(flat, lod)
    np.testing.assert_array_equal(got.data.numpy(), want.data)
    np.testing.assert_array_equal(got.lens.numpy(), want.lens)
    back, back_lod = tlod.lodarray_to_flat(got)
    np.testing.assert_array_equal(back, flat)
    assert back_lod == lod
    with pytest.raises(NotImplementedError, match="nested"):
        tlod.flat_to_lodarray(flat, [[0, 2, 4], lod[0]])


@pytest.mark.parametrize("form", ["lodarray", "flat_and_lod", "list"])
def test_executor_lod_feed_forms_and_fetch(form):
    """The three LoD feed forms reach the program as the same LoDArray (on
    the executor's device, data cast to the var's dtype, int32 lengths);
    the fetch hands back a LoDArray of numpy arrays, as the reference's
    hands back its LoDArray."""
    rng = np.random.RandomState(2)
    seqs = [rng.randint(0, 9, (n, 1)).astype("int32") for n in LENS]
    feed = {"lodarray": lambda: tlod.pack_sequences(seqs),
            "flat_and_lod": lambda: (np.concatenate(seqs),
                                     tlod.lod_from_lens(LENS)),
            "list": lambda: seqs}[form]()
    results = []
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            words = fluid.layers.data("words", shape=[1], dtype="int64",
                                      lod_level=1)
        jfeed = feed
        if fluid is jfluid and form == "lodarray":
            jfeed = jlod.pack_sequences(seqs)
        out, = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={"words": jfeed}, fetch_list=[words],
            scope=fluid.Scope())
        results.append(out)
    want, got = results
    assert isinstance(got, tlod.LoDArray)
    assert got.data.dtype == np.int64 and got.lens.dtype == np.int32
    np.testing.assert_array_equal(got.data, np.asarray(want.data))
    np.testing.assert_array_equal(got.lens, np.asarray(want.lens))
    flat, lod = tlod.lodarray_to_flat(got)
    np.testing.assert_array_equal(flat, np.concatenate(seqs))
    assert lod == tlod.lod_from_lens(LENS)


def test_lookup_table_and_grad():
    """The lookup keeps the ids' LoD; the dense grad masks padded
    positions and scatter-adds repeated ids."""
    rng = np.random.RandomState(3)
    ids = Lod(rng.randint(0, 6, (4, 5, 1)).astype("int64"))
    w = rng.normal(0, 1, (6, 3)).astype("float32")
    out, = _both("lookup_table", {"W": ["w"], "Ids": ["ids"]},
                 {"Out": ["out"]}, {"is_sparse": False, "padding_idx": None},
                 {"w": w, "ids": ids})
    assert out.data.shape == (4, 5, 3)
    dout = Lod(rng.normal(0, 1, out.data.shape).astype("float32"))
    dw, = _both("lookup_table_grad",
                {"W": ["w"], "Ids": ["ids"], "Out@GRAD": ["dout"]},
                {"W@GRAD": ["dw"]}, {"is_sparse": False},
                {"w": w, "ids": ids, "dout": dout})
    mask = np.arange(5)[None, :] < LENS[:, None]
    want = np.zeros_like(w)
    np.add.at(want, ids.data[..., 0][mask], dout.data[mask])
    np.testing.assert_allclose(dw, want, **TOL)


def test_sequence_pool_last_and_grad():
    """LAST takes each row's last valid step (step 0 of an empty row); the
    grad puts the output grad back there and zeros everywhere else."""
    rng = np.random.RandomState(4)
    x = Lod(_padded(rng, 3))
    out, = _both("sequence_pool", {"X": ["x"]}, {"Out": ["out"]},
                 {"pooltype": "LAST"}, {"x": x})
    np.testing.assert_array_equal(
        out, x.data[np.arange(4), np.maximum(LENS - 1, 0)])
    dout = rng.normal(0, 1, out.shape).astype("float32")
    dx, = _both("sequence_pool_grad", {"X": ["x"], "Out@GRAD": ["dout"]},
                {"X@GRAD": ["dx"]}, {"pooltype": "LAST"},
                {"x": x, "dout": dout})
    assert np.count_nonzero(dx.data) == np.count_nonzero(dout)
    np.testing.assert_array_equal(dx.lens, LENS)


@pytest.mark.parametrize("soft_label", [False, True])
def test_cross_entropy_and_softmax_grads(soft_label):
    """softmax -> cross_entropy and back, the classifier's loss head."""
    rng = np.random.RandomState(5)
    logits = rng.normal(0, 2, (6, 4)).astype("float32")
    label = (rng.dirichlet(np.ones(4), 6).astype("float32") if soft_label
             else rng.randint(0, 4, (6, 1)).astype("int64"))
    prob, = _both("softmax", {"X": ["x"]}, {"Out": ["p"]}, {},
                  {"x": logits})
    attrs = {"soft_label": soft_label}
    _both("cross_entropy", {"X": ["p"], "Label": ["label"]}, {"Y": ["y"]},
          attrs, {"p": prob, "label": label})
    dy = rng.normal(0, 1, (6, 1)).astype("float32")
    dprob, = _both("cross_entropy_grad",
                   {"X": ["p"], "Label": ["label"], "Y@GRAD": ["dy"]},
                   {"X@GRAD": ["dp"]}, attrs,
                   {"p": prob, "label": label, "dy": dy})
    _both("softmax_grad", {"Out": ["p"], "Out@GRAD": ["dp"]},
          {"X@GRAD": ["dx"]}, {}, {"p": prob, "dp": dprob})


def test_mul_and_grad_on_lod():
    """mul on a LoDArray flattens from its padded [b, L, feat] layout, one
    dim further than the attribute says; X's grad keeps the lengths."""
    rng = np.random.RandomState(6)
    x = Lod(_padded(rng, 3))
    y = rng.normal(0, 1, (3, 8)).astype("float32")
    attrs = {"x_num_col_dims": 1, "y_num_col_dims": 1}
    out, = _both("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]}, attrs,
                 {"x": x, "y": y})
    assert out.data.shape == (4, 5, 8)
    dout = Lod(_padded(rng, 8))
    _both("mul_grad", {"X": ["x"], "Y": ["y"], "Out@GRAD": ["dout"]},
          {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, attrs,
          {"x": x, "y": y, "dout": dout})


def test_elementwise_add_and_grad_on_lod():
    """A bias over a LoDArray: the reference's axis counts in the flat
    layout, so axis 1 lines the bias up with the feature dim."""
    rng = np.random.RandomState(7)
    x = Lod(_padded(rng, 3))
    bias = rng.normal(0, 1, (3,)).astype("float32")
    out, = _both("elementwise_add", {"X": ["x"], "Y": ["b"]},
                 {"Out": ["out"]}, {"axis": 1}, {"x": x, "b": bias})
    dout = Lod(_padded(rng, 3))
    _both("elementwise_add_grad",
          {"X": ["x"], "Y": ["b"], "Out": ["out"], "Out@GRAD": ["dout"]},
          {"X@GRAD": ["dx"], "Y@GRAD": ["db"]}, {"axis": 1},
          {"x": x, "b": bias, "out": out, "dout": dout})


def test_sum_and_fill_zeros_like_keep_lod():
    """The backward's rename-and-sum and its zero grads keep a LoD
    gradient's lengths, so its padded positions stay masked downstream."""
    rng = np.random.RandomState(8)
    a, b = Lod(_padded(rng, 3)), Lod(_padded(rng, 3))
    total, = _both("sum", {"X": ["a", "b"]}, {"Out": ["s"]}, {},
                   {"a": a, "b": b})
    np.testing.assert_allclose(total.data, a.data + b.data, **TOL)
    zeros, = _both("fill_zeros_like", {"X": ["a"]}, {"Out": ["z"]}, {},
                   {"a": a})
    assert not zeros.data.any()
    np.testing.assert_array_equal(zeros.lens, LENS)


def test_scale():
    rng = np.random.RandomState(9)
    x = rng.normal(0, 1, (1,)).astype("float32")
    _both("scale", {"X": ["x"]}, {"Out": ["y"]},
          {"scale": 0.9, "bias": 0.0}, {"x": x})
