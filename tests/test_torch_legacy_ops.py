"""The op types the legacy layer DSL reaches (lrn, maxout, im2sequence,
rank_loss, nce, pad, crop and their grads, positive_negative_pair), and
the fluid layers that append them, against the reference's, one op at a
time on the same seeded inputs: float32 within rtol 1e-5 / atol 1e-6 of
the largest element, integer outputs exact. Every grad op takes the
forward's outputs and a seeded cotangent in both packages. nce runs with
``custom_neg_classes``, the reference's hook for fixed negatives; with
drawn negatives its SampleLabels are held by their rule."""

import numpy as np
import pytest

from torch_cross import (op_both, run_op, build_both, assert_same_program,
                         cross_losses)
import paddle_tpu_torch.fluid as tfluid


def _f32(rng, *shape, scale=1.0):
    return rng.normal(0, scale, shape).astype("float32")


def _fwd_grad(op_type, ins, outs, attrs, feeds, grad_ins, grad_outs, rng,
              cot="Out"):
    """The forward op, then its grad op fed the forward's outputs and a
    seeded cotangent of the ``cot`` output."""
    got = op_both(op_type, ins, outs, attrs, feeds)
    out_vals = dict(zip([n for ns in outs.values() for n in ns], got))
    d = outs[cot][0]
    gfeeds = {n: v for n, v in {**feeds, **out_vals}.items()
              if any(n in ns for ns in grad_ins.values())}
    dshape = np.shape(out_vals[d][0] if isinstance(out_vals[d], tuple)
                      else out_vals[d])
    if op_type == "im2sequence":      # the padded [b, steps, d] cotangent
        dshape = (feeds["x"].shape[0], dshape[0] // feeds["x"].shape[0],
                  dshape[1])
    gfeeds["d"] = _f32(rng, *dshape)
    op_both(op_type + "_grad", {**grad_ins, cot + "@GRAD": ["d"]},
            grad_outs, attrs, gfeeds)
    return got


CASES = {
    "lrn": lambda rng: (
        {"X": ["x"]}, {"Out": ["out"], "MidOut": ["mid"]},
        {"n": 5, "k": 1.0, "alpha": 1e-4 / 5, "beta": 0.75},
        {"x": _f32(rng, 2, 7, 5, 4, scale=3.0)},
        {"X": ["x"]}, {"X@GRAD": ["dx"]}, "Out"),
    "lrn_even_window": lambda rng: (
        {"X": ["x"]}, {"Out": ["out"], "MidOut": ["mid"]},
        {"n": 4, "k": 2.0, "alpha": 0.01, "beta": 0.5},
        {"x": _f32(rng, 2, 6, 3, 3)},
        {"X": ["x"]}, {"X@GRAD": ["dx"]}, "Out"),
    "maxout": lambda rng: (
        {"X": ["x"]}, {"Out": ["out"]}, {"groups": 3},
        {"x": _f32(rng, 2, 6, 4, 5)},
        {"X": ["x"]}, {"X@GRAD": ["dx"]}, "Out"),
    "im2sequence": lambda rng: (
        {"X": ["x"]}, {"Out": ["out"]},
        {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0, 0, 1]},
        {"x": _f32(rng, 3, 2, 5, 6)},
        {"X": ["x"]}, {"X@GRAD": ["dx"]}, "Out"),
    "rank_loss": lambda rng: (
        {"Label": ["label"], "Left": ["l"], "Right": ["r"]},
        {"Out": ["out"]}, {},
        {"label": rng.randint(0, 2, (8, 1)).astype("float32"),
         "l": _f32(rng, 8, 1, scale=2.0), "r": _f32(rng, 8, 1, scale=2.0)},
        {"Label": ["label"], "Left": ["l"], "Right": ["r"]},
        {"Left@GRAD": ["dl"], "Right@GRAD": ["dr"]}, "Out"),
    "nce": lambda rng: (
        {"Input": ["x"], "Label": ["label"], "Weight": ["w"],
         "Bias": ["b"], "SampleWeight": ["sw"]},
        {"Cost": ["cost"], "SampleLabels": ["samples"]},
        {"num_total_classes": 12, "num_neg_samples": 4,
         "custom_neg_classes": [3, 0, 11, 7]},
        {"x": _f32(rng, 6, 5), "label": rng.randint(0, 12, (6, 1))
         .astype("int64"), "w": _f32(rng, 12, 5), "b": _f32(rng, 12),
         "sw": rng.uniform(0.5, 1.5, (6, 1)).astype("float32")},
        {"Input": ["x"], "Weight": ["w"], "Bias": ["b"],
         "SampleWeight": ["sw"], "SampleLabels": ["samples"]},
        {"Input@GRAD": ["dx"], "Weight@GRAD": ["dw"], "Bias@GRAD": ["db"]},
        "Cost"),
    "nce_no_bias": lambda rng: (
        {"Input": ["x"], "Label": ["label"], "Weight": ["w"]},
        {"Cost": ["cost"], "SampleLabels": ["samples"]},
        {"num_total_classes": 9, "num_neg_samples": 2,
         "custom_neg_classes": [1, 8]},
        {"x": _f32(rng, 5, 4), "label": rng.randint(0, 9, (5, 1))
         .astype("int64"), "w": _f32(rng, 9, 4)},
        {"Input": ["x"], "Weight": ["w"], "SampleLabels": ["samples"]},
        {"Input@GRAD": ["dx"], "Weight@GRAD": ["dw"]}, "Cost"),
    "pad": lambda rng: (
        {"X": ["x"]}, {"Out": ["out"]},
        {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": 0.5},
        {"x": _f32(rng, 2, 3, 4)},
        {"X": ["x"]}, {"X@GRAD": ["dx"]}, "Out"),
    "crop": lambda rng: (
        {"X": ["x"]}, {"Out": ["out"]},
        {"shape": [-1, 3, 2], "offsets": [1, 1, 2]},
        {"x": _f32(rng, 4, 5, 6)},
        {"X": ["x"]}, {"X@GRAD": ["dx"]}, "Out"),
    "crop_by_reference": lambda rng: (
        {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]}, {"offsets": [0, 2]},
        {"x": _f32(rng, 4, 7), "y": _f32(rng, 3, 4)},
        {"X": ["x"]}, {"X@GRAD": ["dx"]}, "Out"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_grad_match_the_reference(case):
    rng = np.random.RandomState(sorted(CASES).index(case))
    ins, outs, attrs, feeds, gins, gouts, cot = CASES[case](rng)
    op_type = case.split("_no_")[0].split("_even_")[0].split("_by_")[0]
    _fwd_grad(op_type, ins, outs, attrs, feeds, gins, gouts, rng, cot)


def test_im2sequence_is_one_sequence_an_image():
    rng = np.random.RandomState(3)
    (flat, lod), = op_both(
        "im2sequence", {"X": ["x"]}, {"Out": ["out"]},
        {"kernels": [2, 2], "strides": [2, 2], "paddings": [0, 0, 0, 0]},
        {"x": _f32(rng, 2, 3, 4, 6)})
    assert flat.shape == (2 * 2 * 3, 3 * 2 * 2)
    assert lod == [[0, 6, 12]]


@pytest.mark.parametrize("weighted", [False, True])
def test_positive_negative_pair_matches_the_reference(weighted):
    """Scores with ties, three queries, accumulators carried in."""
    rng = np.random.RandomState(7 + weighted)
    n = 12
    score = np.round(rng.uniform(0, 1, (n, 2)), 1).astype("float32")
    feeds = {"score": score,
             "label": rng.randint(0, 3, (n, 1)).astype("int64"),
             "query": rng.randint(0, 3, (n, 1)).astype("int64"),
             "ap": np.array([1.5], "float32"),
             "an": np.array([0.5], "float32"),
             "au": np.array([2.0], "float32")}
    ins = {"Score": ["score"], "Label": ["label"], "QueryID": ["query"],
           "AccumulatePositivePair": ["ap"],
           "AccumulateNegativePair": ["an"],
           "AccumulateNeutralPair": ["au"]}
    if weighted:
        feeds["w"] = rng.uniform(0.5, 2.0, (n, 1)).astype("float32")
        ins["Weight"] = ["w"]
    got = op_both("positive_negative_pair", ins,
                  {"PositivePair": ["pos"], "NegativePair": ["neg"],
                   "NeutralPair": ["neu"]}, {"column": 0}, feeds)
    assert float(got[2][0]) > 2.0      # the ties counted as neutral


def test_nce_draws_its_negatives_in_range():
    """Without custom negatives the port draws from its generator: the
    SampleLabels are the labels, then num_neg ids in [0, classes)."""
    rng = np.random.RandomState(11)
    feeds = {"x": _f32(rng, 6, 5),
             "label": rng.randint(0, 10, (6, 1)).astype("int64"),
             "w": _f32(rng, 10, 5), "b": _f32(rng, 10)}
    cost, samples = run_op(
        tfluid, "nce",
        {"Input": ["x"], "Label": ["label"], "Weight": ["w"],
         "Bias": ["b"]}, {"Cost": ["cost"], "SampleLabels": ["samples"]},
        {"num_total_classes": 10, "num_neg_samples": 3}, feeds)
    assert samples.shape == (6, 4) and samples.dtype == np.int32
    np.testing.assert_array_equal(samples[:, :1], feeds["label"])
    assert samples[:, 1:].min() >= 0 and samples[:, 1:].max() < 10
    assert cost.shape == (6, 1) and np.isfinite(cost).all()


def _layers_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[6, 5, 4])
        a = fluid.layers.lrn(img, n=3, alpha=1e-3)
        b = fluid.layers.maxout(a, groups=2)
        c = fluid.layers.pad(b, [0, 0, 0, 0, 1, 1, 0, 2])
        d = fluid.layers.crop(c, shape=[-1, 3, 6, 5], offsets=[0, 0, 0, 1])
        seq = fluid.layers.im2sequence(d, filter_size=[2, 3], stride=1)
        feat = fluid.layers.sequence_pool(seq, "average")
        left = fluid.layers.fc(feat, 1)
        right = fluid.layers.fc(feat, 1)
        label = fluid.layers.data("label", shape=[1])
        rl = fluid.layers.rank_loss(label, left, right)
        cls = fluid.layers.data("cls", shape=[1], dtype="int64")
        nc = fluid.layers.nce(feat, cls, num_total_classes=7,
                              num_neg_samples=3,
                              custom_neg_classes=[0, 4, 6])
        loss = fluid.layers.mean(fluid.layers.elementwise_add(rl, nc))
        fluid.optimizer.SGD(0.1).minimize(loss, startup)
    return main, startup, loss


def test_layers_build_the_reference_program_and_train_alike():
    progs = build_both(_layers_program)
    assert_same_program(progs["port"][0], progs["ref"][0])
    rng = np.random.RandomState(5)
    feed = {"img": _f32(rng, 4, 6, 5, 4),
            "label": rng.randint(0, 2, (4, 1)).astype("float32"),
            "cls": rng.randint(0, 7, (4, 1)).astype("int64")}
    cross_losses(progs, feed, steps=5)
