"""The port's metric ops and evaluators against the reference's: accuracy,
auc, precision_recall and chunk_eval as one-op programs on the same
seeded inputs (float32 within rtol 1e-5 / atol 1e-6 of the largest
element, counts exact), then the Accuracy, ChunkEvaluator and Auc
evaluators over several batches, by the host pattern and from their
persistable states."""

import numpy as np
import pytest

from torch_cross import assert_op_close, op_both, run_op
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops.metrics import extract_chunks as ref_extract_chunks
from paddle_tpu_torch.ops.metrics import extract_chunks


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy(k):
    rng = np.random.RandomState(k)
    n, c = 40, 7
    probs = rng.rand(n, c).astype("float32")
    idx = np.argsort(-probs, axis=1)[:, :k].astype("int64")
    feeds = {"out": np.take_along_axis(probs, idx, 1), "idx": idx,
             "label": rng.randint(0, c, (n, 1)).astype("int64")}
    acc, correct, total = op_both(
        "accuracy", {"Out": ["out"], "Indices": ["idx"], "Label": ["label"]},
        {"Accuracy": ["acc"], "Correct": ["correct"], "Total": ["total"]},
        {}, feeds)
    want = int(np.any(idx == feeds["label"], axis=1).sum())
    assert int(correct) == want and int(total) == n
    assert correct.dtype == np.int32 and total.dtype == np.int32
    assert float(acc) == np.float32(want) / n


@pytest.mark.parametrize("curve", ["ROC", "PR"])
def test_auc(curve):
    """Predictions drawn from the seed, not steered off the thresholds; a
    TP/FN/TN/FP count that differs is printed with its threshold."""
    rng = np.random.RandomState(5)
    n, t = 300, 50
    labels = rng.randint(0, 2, (n, 1)).astype("int64")
    pred = rng.rand(n, 2).astype("float32")
    names = ["auc", "tp", "fn", "tn", "fp"]
    outs = {"AUC": ["auc"], "TPOut": ["tp"], "FNOut": ["fn"],
            "TNOut": ["tn"], "FPOut": ["fp"]}
    args = ("auc", {"Out": ["pred"], "Label": ["label"]}, outs,
            {"curve": curve, "num_thresholds": t},
            {"pred": pred, "label": labels})
    want = run_op(jfluid, *args)
    got = run_op(tfluid, *args)
    for name, g, w in zip(names[1:], got[1:], want[1:]):
        bad = np.nonzero(g != w)[0]
        for i in bad:
            print(f"auc {curve} {name}: threshold {i} port {g[i]} "
                  f"reference {w[i]}")
        assert bad.size == 0, name
    assert_op_close(got[0], want[0], "auc")


@pytest.mark.parametrize("weights,states", [(False, False), (True, True)],
                         ids=["plain", "weighted_with_states"])
def test_precision_recall(weights, states):
    rng = np.random.RandomState(7)
    n, c = 60, 5
    feeds = {"idx": rng.randint(0, c, (n, 1)).astype("int64"),
             "labels": rng.randint(0, c, (n, 1)).astype("int64")}
    ins = {"Indices": ["idx"], "Labels": ["labels"]}
    if weights:
        feeds["w"] = rng.rand(n, 1).astype("float32")
        ins["Weights"] = ["w"]
    if states:
        feeds["st"] = rng.randint(0, 9, (c, 4)).astype("float32")
        ins["StatesInfo"] = ["st"]
    op_both("precision_recall", ins,
            {"BatchMetrics": ["bm"], "AccumMetrics": ["am"],
             "AccumStatesInfo": ["ast"]}, {"class_number": c}, feeds)


def _tag_seqs(rng, n, num_tags, lens=(1, 12)):
    return [rng.randint(0, num_tags, (int(rng.randint(*lens)), 1))
            .astype("int64") for _ in range(n)]


@pytest.mark.parametrize("scheme,width", [("IOB", 2), ("IOE", 2),
                                          ("IOBES", 4), ("plain", 1)])
def test_chunk_eval(scheme, width):
    """Tags drawn over every chunk type and one Outside tag past them; the
    three counts exact, and equal to a recount by the reference's
    extract_chunks."""
    rng = np.random.RandomState(11)
    types = 3
    inf = _tag_seqs(rng, 9, types * width + 1)
    lab = [np.where(rng.rand(*s.shape) < 0.7, s,
                    rng.randint(0, types * width + 1, s.shape))
           .astype("int64") for s in inf]
    excluded = [1] if scheme == "IOB" else []
    got = op_both("chunk_eval", {"Inference": ["inf"], "Label": ["lab"]},
                  {"Precision": ["p"], "Recall": ["r"], "F1-Score": ["f1"],
                   "NumInferChunks": ["ni"], "NumLabelChunks": ["nl"],
                   "NumCorrectChunks": ["nc"]},
                  {"chunk_scheme": scheme, "num_chunk_types": types,
                   "excluded_chunk_types": excluded},
                  {"inf": inf, "lab": lab}, lod=("inf", "lab"))
    sets = [(ref_extract_chunks(a.ravel(), scheme, types, tuple(excluded)),
             ref_extract_chunks(b.ravel(), scheme, types, tuple(excluded)))
            for a, b in zip(inf, lab)]
    assert int(got[3][0]) == sum(len(a) for a, _ in sets)
    assert int(got[4][0]) == sum(len(b) for _, b in sets)
    assert int(got[5][0]) == sum(len(a & b) for a, b in sets)
    assert got[3].dtype == np.int64


def test_extract_chunks_matches_the_reference():
    rng = np.random.RandomState(13)
    for scheme, width in (("IOB", 2), ("IOE", 2), ("IOBES", 4),
                          ("plain", 1)):
        for _ in range(50):
            tags = rng.randint(-1, 3 * width + 2, int(rng.randint(0, 15)))
            assert extract_chunks(tags, scheme, 3) \
                == ref_extract_chunks(tags, scheme, 3), (scheme, tags)


def _evaluator_program(fluid, kind):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        layers = fluid.layers
        if kind == "accuracy":
            x = layers.data("x", shape=[6])
            label = layers.data("l", shape=[1], dtype="int64")
            ev = fluid.evaluator.Accuracy(layers.fc(x, 4, act="softmax"),
                                          label, k=2)
        elif kind == "chunk":
            inf = layers.data("inf", shape=[1], dtype="int64", lod_level=1)
            label = layers.data("l", shape=[1], dtype="int64", lod_level=1)
            ev = fluid.evaluator.ChunkEvaluator(inf, label, "IOB", 3)
        else:
            p = layers.data("p", shape=[1])
            label = layers.data("l", shape=[1], dtype="int64")
            ev = fluid.evaluator.Auc(p, label, num_thresholds=40)
    return main, startup, ev


def _evaluator_feeds(kind, rng):
    if kind == "accuracy":
        return {"x": rng.normal(0, 1, (16, 6)).astype("float32"),
                "l": rng.randint(0, 4, (16, 1)).astype("int64")}
    if kind == "chunk":
        inf = _tag_seqs(rng, 6, 7)
        return {"inf": inf, "l": [np.where(rng.rand(*s.shape) < 0.6, s, 6)
                                  .astype("int64") for s in inf]}
    lab = rng.randint(0, 2, (50, 1)).astype("int64")
    return {"p": np.clip(0.4 * lab + 0.7 * rng.rand(50, 1), 0, 1)
            .astype("float32"), "l": lab}


@pytest.mark.parametrize("kind", ["accuracy", "chunk", "auc"])
def test_evaluator_accumulates_like_the_reference(kind):
    """Three batches: the port's host pattern (fetch ``metrics``,
    ``update``, ``eval()``) equals the reference's; its states in the
    scope give the same metric; the reset program zeroes them. (The
    port's scope holds the reference's startup state, so its states come
    from the reset program.)"""
    from torch_cross import build_both, port_scope, ref_state
    progs = build_both(lambda f: _evaluator_program(f, kind))
    (jmain, jstart, jev), (tmain, _, tev) = progs["ref"], progs["port"]
    jexe, jscope, state = ref_state(jmain, jstart, mode="eager")
    jexe = jfluid.Executor(jfluid.CPUPlace(), mode="eager")
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = port_scope(state)
    for s in tev.states:        # the port's own states, not the reference's
        assert tscope.find_var(s.name) is None
    tev.reset(texe, tscope)     # the reset program creates them at zero
    rng = np.random.RandomState(17)
    for _ in range(3):
        feed = _evaluator_feeds(kind, rng)
        jev.update(jexe.run(jmain, feed=feed, fetch_list=jev.metrics,
                            scope=jscope))
        tev.update(texe.run(tmain, feed=feed, fetch_list=tev.metrics,
                            scope=tscope))
    want, host, states = jev.eval(), tev.eval(), tev.eval(texe, tscope)
    np.testing.assert_allclose(host, want, rtol=1e-6)
    np.testing.assert_allclose(states, want, rtol=1e-6)
    tev.reset(texe, tscope)
    for s in tev.states:
        assert not np.asarray(tscope.find_var(s.name)).any()
