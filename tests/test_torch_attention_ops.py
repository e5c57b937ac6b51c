"""The port's attention, layer_norm and dense beam_search ops against the
reference's, one op at a time on the same numpy inputs.

``causal_self_attention``, ``prefill_attention`` and
``chunked_prefill_attention`` (``ops/attention_ops.py``), ``layer_norm``
(``ops/norm_ops.py``) and the dense ``beam_search``
(``ops/control_flow_ops.py``). The arena outputs of the phase ops are
bitwise the reference's; the attention outputs agree to float32 roundings
(the packages sum the einsums in other orders).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

# float32 einsums over at most 32 terms and a softmax: the two packages
# order the sums differently
TOL = dict(rtol=1e-5, atol=1e-6)


def _run_op(fluid, op_type, inputs, out_slots, attrs):
    """One op in a fresh program on the CPU; feeds COPIES of the inputs
    (the port's phase ops write the fed arena in place, and a CPU feed
    shares the numpy array's memory)."""
    main = fluid.Program()
    block = main.global_block()
    for name, arr in inputs.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                         is_data=True)
    for name in out_slots:
        block.create_var(name=name)
    block.append_op(op_type, {n: [n] for n in inputs},
                    {n: [n] for n in out_slots}, attrs)
    outs = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={n: a.copy() for n, a in inputs.items()},
        fetch_list=list(out_slots), scope=fluid.Scope())
    return [np.asarray(o) for o in outs]


def _both(op_type, inputs, out_slots, attrs):
    return (_run_op(tfluid, op_type, inputs, out_slots, attrs),
            _run_op(jfluid, op_type, inputs, out_slots, attrs))


def _qkv(rng, b, t, e):
    return {n: rng.normal(0, 1, (b, t, e)).astype("float32")
            for n in ("Q", "K", "V")}


@pytest.mark.parametrize("b,t,h,d", [(2, 5, 2, 4), (1, 8, 4, 8),
                                     (3, 1, 1, 16)])
def test_causal_self_attention(b, t, h, d):
    inputs = _qkv(np.random.RandomState(t), b, t, h * d)
    got, want = _both("causal_self_attention", inputs, ["Out"],
                      {"num_heads": h})
    np.testing.assert_allclose(got[0], want[0], **TOL)


def _arena(rng, nb, bs, h, d):
    return {"KCache": rng.normal(0, 1, (nb, bs, h, d)).astype("float32"),
            "VCache": rng.normal(0, 1, (nb, bs, h, d)).astype("float32")}


@pytest.mark.parametrize("n_real", [8, 5, 1])
def test_prefill_attention(n_real):
    """A bucket of 8 with ``n_real`` prompt positions: the rest map to the
    sentinel slot. Out within float32 roundings; the arenas bitwise."""
    rng = np.random.RandomState(n_real)
    h, d, nb, bs = 2, 4, 6, 4
    inputs = _qkv(rng, 1, 8, h * d)
    inputs.update(_arena(rng, nb, bs, h, d))
    slots = np.full((1, 8), nb * bs, np.int32)
    slots[0, :n_real] = rng.permutation(nb * bs)[:n_real]
    inputs["SlotMapping"] = slots
    outs = ["Out", "KCacheOut", "VCacheOut"]
    got, want = _both("prefill_attention", inputs, outs, {"num_heads": h})
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("start,n_real", [(0, 8), (4, 3), (9, 6)])
def test_chunked_prefill_attention(start, n_real):
    """A chunk at absolute position ``start`` over a table of 4 blocks:
    the chunk's rows scatter in, then every position attends causally over
    the gathered context."""
    rng = np.random.RandomState(start)
    h, d, nb, bs, p = 2, 4, 8, 4, 4
    inputs = _qkv(rng, 1, 8, h * d)
    inputs.update(_arena(rng, nb, bs, h, d))
    bt = rng.permutation(nb)[:p].astype(np.int32).reshape(1, p)
    pos = start + np.arange(n_real)
    slots = np.full((1, 8), nb * bs, np.int32)
    slots[0, :n_real] = bt[0, pos // bs] * bs + pos % bs
    inputs.update(SlotMapping=slots, BlockTables=bt,
                  ChunkStart=np.asarray([start], np.int32))
    outs = ["Out", "KCacheOut", "VCacheOut"]
    got, want = _both("chunked_prefill_attention", inputs, outs,
                      {"num_heads": h})
    np.testing.assert_allclose(got[0][:, :n_real], want[0][:, :n_real],
                               **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("axis,shape", [(2, (2, 3, 8)), (1, (4, 6)),
                                        (1, (2, 3, 5))])
def test_layer_norm(axis, shape):
    rng = np.random.RandomState(sum(shape))
    n = int(np.prod(shape[axis:]))
    inputs = {"X": rng.normal(1, 2, shape).astype("float32"),
              "Scale": rng.uniform(0.5, 1.5, n).astype("float32"),
              "Bias": rng.normal(0, 0.5, n).astype("float32")}
    got, want = _both("layer_norm", inputs, ["Y", "Mean", "Variance"],
                      {"begin_norm_axis": axis, "epsilon": 1e-5})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("end_id", [0, 3, -1])
def test_dense_beam_search(end_id):
    """Two sources of beam 3 with k 3 candidates; a finished beam (its
    pre_id is end_id) continues only with end_id, and its k - 1 masked
    candidates tie at -1e9; equal scores elsewhere tie too. Ids, scores
    and parents equal the reference's (which takes the lower flat index
    first on ties)."""
    rng = np.random.RandomState(end_id + 5)
    pre_ids = np.asarray([[3, 1, 4], [0, 3, 2]], np.int64)
    pre_scores = rng.normal(-1, 0.5, (2, 3)).astype("float32")
    ids = rng.randint(0, 6, (2, 3, 3)).astype(np.int64)
    scores = np.log(rng.dirichlet(np.ones(3), (2, 3))).astype("float32")
    scores[1, 2] = scores[1, 1]
    pre_scores[1, 2] = pre_scores[1, 1]
    inputs = {"pre_ids": pre_ids, "pre_scores": pre_scores, "ids": ids,
              "scores": scores}
    outs = ["selected_ids", "selected_scores", "parent_idx"]
    got, want = _both("beam_search", inputs, outs,
                      {"beam_size": 3, "end_id": end_id})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dense_beam_search_selects_among_masked_ties():
    """Both beams finished and beam_size 3 over 2 beams: the third pick is
    one of four candidates tied at -1e9, and it must be the one with the
    lower flat index, as the reference's top_k takes it."""
    inputs = {"pre_ids": np.asarray([[2, 2]], np.int64),
              "pre_scores": np.asarray([[-0.5, -0.25]], np.float32),
              "ids": np.asarray([[[5, 1, 4], [3, 0, 1]]], np.int64),
              "scores": np.log(np.full((1, 2, 3), 1 / 3, np.float32))}
    outs = ["selected_ids", "selected_scores", "parent_idx"]
    got, want = _both("beam_search", inputs, outs,
                      {"beam_size": 3, "end_id": 2})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], [[1, 0, 0]])
