"""The SSD op family and detection_map in the port against the reference
(counterpart of tests/test_detection_ops.py): one op a program, the same
seeded numpy inputs through both packages (the reference's eager
executor). Float outputs within rtol 1e-5 and 1e-6 of the largest element
(``torch_cross.assert_op_close``), integer outputs exactly.

multiclass_nms gets boxes whose pairwise IoUs keep a margin of 1e-3 from
every threshold the run can reach (the eta-decayed ones too), so the
float32 rounding of either package cannot move a box across one: the kept
sets, labels, counts and row order are then required exactly, scores and
boxes within 1e-6."""

import numpy as np
import pytest
import torch

from torch_cross import op_both, run_op, jfluid, tfluid


def boxes(rng, n, lo=0.6, size=(0.05, 0.4)):
    p1 = rng.rand(n, 2) * lo
    wh = rng.rand(n, 2) * (size[1] - size[0]) + size[0]
    return np.concatenate([p1, p1 + wh], axis=1).astype("float32")


# ---------------------------------------------------------------------------
# iou_similarity, prior_box, box_coder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lod", [False, True], ids=["dense", "lod"])
def test_iou_similarity(lod):
    rng = np.random.RandomState(0)
    x = [boxes(rng, 3), boxes(rng, 5)] if lod else boxes(rng, 5)
    op_both("iou_similarity", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]},
            {}, {"x": x, "y": boxes(rng, 7)}, lod=("x",) if lod else ())


PRIOR_CASES = {
    "ssd_first_map": dict(min_sizes=[30.0], max_sizes=[60.0],
                          aspect_ratios=[2.0], flip=True, clip=True),
    "ssd_later_map": dict(min_sizes=[111.0], max_sizes=[162.0],
                          aspect_ratios=[2.0, 3.0], flip=True, clip=True),
    "no_max_steps_offset": dict(min_sizes=[4.0, 8.0], aspect_ratios=[2.0],
                                flip=False, clip=False, step_w=7.0,
                                step_h=9.0, offset=0.3,
                                variances=[0.1, 0.2, 0.3, 0.4]),
    "flip_dedup": dict(min_sizes=[8.0], max_sizes=[16.0],
                       aspect_ratios=[2.0, 0.5], flip=True),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_prior_box(case):
    rng = np.random.RandomState(1)
    feeds = {"feat": rng.rand(1, 4, 5, 3).astype("float32"),
             "img": rng.rand(1, 3, 300, 200).astype("float32")}
    op_both("prior_box", {"Input": ["feat"], "Image": ["img"]},
            {"Boxes": ["b"], "Variances": ["v"]}, PRIOR_CASES[case], feeds)


def _coder_feeds(rng, target_shape):
    prior = boxes(rng, 6)
    feeds = {"pb": prior,
             "pv": (rng.rand(6, 4) + 0.1).astype("float32")}
    if target_shape == "boxes":
        feeds["tb"] = boxes(rng, 5)
    elif target_shape == "aligned":
        t = boxes(rng, 12).reshape(2, 6, 4)
        t[0, 2] = 0.0                  # an unmatched prior's zero target
        feeds["tb"] = t
    else:
        feeds["tb"] = rng.normal(0, 0.5, target_shape).astype("float32")
    return feeds


@pytest.mark.parametrize("code_type,target,var", [
    ("encode_center_size", "boxes", True),
    ("encode_center_size", "aligned", True),
    ("encode_center_size", "aligned", False),
    ("decode_center_size", (3, 6, 4), True),
    ("decode_center_size", (5, 4), False),
], ids=["encode", "encode_aligned", "encode_aligned_unit_var", "decode",
        "decode_rows_unit_var"])
def test_box_coder(code_type, target, var):
    feeds = _coder_feeds(np.random.RandomState(2), target)
    inputs = {"PriorBox": ["pb"], "TargetBox": ["tb"]}
    if var:
        inputs["PriorBoxVar"] = ["pv"]
    else:
        feeds.pop("pv")
    op_both("box_coder", inputs, {"OutputBox": ["out"]},
            {"code_type": code_type}, feeds)


# ---------------------------------------------------------------------------
# bipartite_match, target_assign, mine_hard_examples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
@pytest.mark.parametrize("lod", [False, True], ids=["dense", "lod"])
def test_bipartite_match(match_type, lod):
    rng = np.random.RandomState(3)
    if lod:
        dist = [rng.rand(n, 9).astype("float32") for n in (2, 5, 1)]
        dist[1][3] = 0.0               # a row that overlaps nothing
    else:
        dist = rng.rand(2, 5, 9).astype("float32")
        dist[0, 2] = 0.0
    op_both("bipartite_match", {"DistMat": ["d"]},
            {"ColToRowMatchIndices": ["mi"], "ColToRowMatchDist": ["md"]},
            {"match_type": match_type, "dist_threshold": 0.5},
            {"d": dist}, lod=("d",) if lod else ())


@pytest.mark.parametrize("kind", ["label", "box"])
def test_target_assign(kind):
    rng = np.random.RandomState(4)
    if kind == "label":
        x = [rng.randint(1, 9, (n, 1)).astype("int64") for n in (3, 1)]
        mismatch = 0
    else:
        x = [boxes(rng, n) for n in (3, 1)]
        mismatch = -1
    match = np.array([[0, -1, 2, 1, -1], [-1, 0, 0, -1, -1]], np.int32)
    op_both("target_assign", {"X": ["x"], "MatchIndices": ["m"]},
            {"Out": ["out"], "OutWeight": ["w"]},
            {"mismatch_value": mismatch}, {"x": x, "m": match}, lod=("x",))


@pytest.mark.parametrize("with_dist", [False, True],
                         ids=["no_dist", "match_dist"])
def test_mine_hard_examples(with_dist):
    rng = np.random.RandomState(5)
    feeds = {"l": rng.rand(3, 40).astype("float32"),
             "m": np.where(rng.rand(3, 40) < 0.15,
                           rng.randint(0, 4, (3, 40)), -1).astype(np.int32)}
    feeds["m"][2] = -1                 # an image with no positive
    inputs = {"ClsLoss": ["l"], "MatchIndices": ["m"]}
    if with_dist:
        feeds["md"] = rng.rand(3, 40).astype("float32")
        inputs["MatchDist"] = ["md"]
    neg, upd = op_both("mine_hard_examples", inputs,
                       {"NegMask": ["neg"], "UpdatedMatchIndices": ["upd"]},
                       {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5},
                       feeds)
    assert neg[:2].sum() > 0 and neg[2].sum() == 0


# ---------------------------------------------------------------------------
# multiclass_nms
# ---------------------------------------------------------------------------

def _iou64(a):
    x1 = np.maximum(a[:, None, 0], a[None, :, 0])
    y1 = np.maximum(a[:, None, 1], a[None, :, 1])
    x2 = np.minimum(a[:, None, 2], a[None, :, 2])
    y2 = np.minimum(a[:, None, 3], a[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    return inter / (area[:, None] + area[None, :] - inter)


def nms_thresholds(nms_threshold, eta, steps=64):
    out, t = [nms_threshold], nms_threshold
    while eta < 1.0 and t > 0.5 and len(out) < steps:
        t *= eta
        out.append(t)
    return out


def margin_boxes(rng, batch, n, thresholds, margin=1e-3):
    """``batch`` images of ``n`` boxes in clusters of 3-6 jittered copies,
    so that many pairs overlap, each image drawn again until no pairwise
    IoU lies within ``margin`` of any of ``thresholds``."""
    out = []
    while len(out) < batch:
        centers = rng.rand(n // 4 + 1, 2) * 0.7 + 0.15
        pick = centers[rng.randint(0, len(centers), n)]
        half = rng.rand(n, 2) * 0.08 + 0.04
        c = pick + rng.normal(0, 0.03, (n, 2))
        b = np.concatenate([c - half, c + half], axis=1).astype("float32")
        iou = _iou64(b.astype(np.float64))[np.triu_indices(n, 1)]
        if all(np.min(np.abs(iou - t)) > margin for t in thresholds):
            out.append(b)
    return np.stack(out)


NMS_CASES = {
    # name: (nms_threshold, eta, nms_top_k, keep_top_k, background_label)
    "default": (0.45, 1.0, -1, 20, 0),
    "nms_top_k_cut": (0.45, 1.0, 6, 20, 0),
    "eta": (0.7, 0.9, -1, -1, 0),
    "keep_all_no_background": (0.3, 1.0, 10, -1, -1),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_multiclass_nms(case):
    nms_t, eta, top_k, keep, bg = NMS_CASES[case]
    rng = np.random.RandomState(6)
    b, c, p = 2, 4, 24
    feeds = {"bb": margin_boxes(rng, b, p, nms_thresholds(nms_t, eta)),
             "sc": rng.rand(b, c, p).astype("float32")}
    args = ("multiclass_nms", {"BBoxes": ["bb"], "Scores": ["sc"]},
            {"Out": ["out"]},
            {"background_label": bg, "score_threshold": 0.1,
             "nms_top_k": top_k, "keep_top_k": keep,
             "nms_threshold": nms_t, "nms_eta": eta}, feeds)
    (got, got_lod), = run_op(tfluid, *args)
    (want, want_lod), = run_op(jfluid, *args)
    assert got_lod == want_lod
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-6)
    counts = np.diff(want_lod[0])
    assert counts.min() > 0
    if bg == 0:
        assert not np.any(want[:, 0] == 0)
    # the cut and the adaptive threshold change what is kept
    if case in ("nms_top_k_cut", "eta"):
        base = dict(args[3], nms_top_k=-1, nms_eta=1.0)
        (plain, plain_lod), = run_op(tfluid, args[0], args[1], args[2], base,
                                     feeds)
        assert plain_lod != got_lod or not np.array_equal(plain, got)


def test_multiclass_nms_rows_past_the_count():
    """The fixed [b, keep_top_k, 6] rows: label -1 and zeros past each
    image's count, the counts the LoD lengths."""
    rng = np.random.RandomState(7)
    feeds = {"bb": margin_boxes(rng, 2, 16, [0.45]),
             "sc": rng.rand(2, 3, 16).astype("float32")}
    feeds["sc"][1, 1:] = 0.05          # image 1: nothing above threshold
    prog = tfluid.Program()
    block = prog.global_block()
    for n, a in feeds.items():
        block.create_var(name=n, shape=a.shape, dtype="float32")
    block.create_var(name="out")
    block.append_op("multiclass_nms", {"BBoxes": ["bb"], "Scores": ["sc"]},
                    {"Out": ["out"]},
                    {"background_label": 0, "score_threshold": 0.1,
                     "nms_top_k": -1, "keep_top_k": 30,
                     "nms_threshold": 0.45})
    out, = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feeds, fetch_list=["out"], scope=tfluid.Scope())
    rows, lens = np.asarray(out.data), np.asarray(out.lens)
    assert rows.shape == (2, 30, 6) and lens.dtype == np.int32
    assert lens[1] == 0 and 0 < lens[0] < 30
    for i, n in enumerate(lens):
        assert np.all(rows[i, n:, 0] == -1) and np.all(rows[i, n:, 1:] == 0)
        assert np.all(np.diff(rows[i, :n, 1]) <= 0)


def staircase(k, step=0.002, width=0.006):
    """k boxes along x, each overlapping the next at IoU 0.5 and the one
    after at 0.2: the longest chain of suppressions NMS can meet."""
    x1 = np.arange(k) * step
    return np.stack([x1, np.zeros(k), x1 + width, np.full(k, 0.5)],
                    1).astype("float32")


@pytest.mark.parametrize("descending", [True, False],
                         ids=["from_the_left", "from_the_right"])
def test_multiclass_nms_long_suppression_chain(descending):
    """A staircase of k = 400 boxes at nms_top_k 400 and threshold 0.45:
    the greedy walk keeps every other box from the best one on, the same
    rows as the reference's, and the fixed-point iteration takes all k
    iterations to get there, the most it can take."""
    from paddle_tpu_torch.ops.detection_ops import iou_matrix, nms_keep
    k = 400
    boxes = staircase(k)
    score = np.linspace(0.9, 0.5, k, dtype="float32")
    if not descending:
        score = score[::-1].copy()
    feeds = {"bb": boxes[None], "sc": np.stack([np.full(k, 0.01, "float32"),
                                                score])[None]}
    args = ("multiclass_nms", {"BBoxes": ["bb"], "Scores": ["sc"]},
            {"Out": ["out"]},
            {"background_label": 0, "score_threshold": 0.1,
             "nms_top_k": k, "keep_top_k": -1, "nms_threshold": 0.45,
             "nms_eta": 1.0}, feeds)
    (got, got_lod), = run_op(tfluid, *args)
    (want, want_lod), = run_op(jfluid, *args)
    assert got_lod == want_lod == [[0, k // 2]]
    np.testing.assert_array_equal(got, want)
    first = 0 if descending else 1
    np.testing.assert_array_equal(got[:, 2:], boxes[first::2][
        slice(None) if descending else slice(None, None, -1)])
    order = np.argsort(-score, kind="stable")
    b = torch.from_numpy(boxes[order])
    keep, iterations = nms_keep(iou_matrix(b, b)[None, None],
                                torch.from_numpy(score[order])[None, None],
                                0.1, 0.45, 1.0, k)
    assert int(keep.sum()) == k // 2 and iterations == k


# ---------------------------------------------------------------------------
# roi_pool
# ---------------------------------------------------------------------------

def test_roi_pool():
    rng = np.random.RandomState(8)
    x = rng.rand(2, 3, 9, 11).astype("float32")
    rois = np.array([[0, 0, 0, 5, 5], [1, 2.4, 1.6, 10, 8],
                     [0, 7, 6, 9, 8], [1, 3, 3, 3, 3]], "float32")
    op_both("roi_pool", {"X": ["x"], "ROIs": ["r"]}, {"Out": ["out"]},
            {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.9},
            {"x": x, "r": rois})


# ---------------------------------------------------------------------------
# detection_map
# ---------------------------------------------------------------------------

def _detections(rng, gts, classes, extra=3):
    """Per image: a jittered detection of each ground truth (its label,
    or another one for every fourth) and ``extra`` random ones, with
    distinct scores."""
    dets = []
    for g in gts:
        rows = []
        for k, r in enumerate(g):
            lbl = r[0] if k % 4 else (r[0] % (classes - 1)) + 1
            box = r[1:5] + rng.normal(0, 0.02, 4)
            rows.append([lbl, rng.rand()] + list(box))
        for _ in range(extra):
            rows.append([rng.randint(1, classes), rng.rand()]
                        + list(boxes(rng, 1)[0]))
        dets.append(np.asarray(rows, "float32"))
    return dets


def _ground_truth(rng, n_images, classes):
    return [np.concatenate([rng.randint(1, classes, (n, 1)),
                            boxes(rng, n)], axis=1).astype("float32")
            for n in rng.randint(1, 5, n_images)]


@pytest.mark.parametrize("ap_type", ["integral", "11point"])
def test_detection_map_op(ap_type):
    rng = np.random.RandomState(9)
    gts = _ground_truth(rng, 4, 5)
    (m,), = [op_both("detection_map", {"DetectRes": ["d"], "Label": ["g"]},
                     {"MAP": ["map"]},
                     {"class_num": 5, "overlap_threshold": 0.5,
                      "ap_type": ap_type},
                     {"d": _detections(rng, gts, 5), "g": gts},
                     lod=("d", "g"))]
    assert 0.0 < float(m[0]) < 1.0


def test_detection_map_op_agrees_with_the_evaluator():
    """The op at ap_type 11point and the port's DetectionMAP evaluator give
    one mAP where every class with ground truth has a detection (the
    evaluator counts a class without one as AP 0, the op leaves it out)."""
    rng = np.random.RandomState(10)
    gts = _ground_truth(rng, 6, 4)
    dets = _detections(rng, gts, 4)
    assert {int(r[0]) for g in gts for r in g} <= \
        {int(r[0]) for d in dets for r in d}
    (m,) = run_op(tfluid, "detection_map",
                  {"DetectRes": ["d"], "Label": ["g"]}, {"MAP": ["map"]},
                  {"class_num": 4, "overlap_threshold": 0.5,
                   "ap_type": "11point"}, {"d": dets, "g": gts},
                  lod=("d", "g"))
    width = max(len(d) for d in dets)
    rows = np.zeros((len(dets), width, 6), "float32")
    for i, d in enumerate(dets):
        rows[i, :len(d)] = d
    ev = tfluid.evaluator.DetectionMAP(overlap_threshold=0.5)
    ev.update(tfluid.LoDArray(torch.from_numpy(rows),
                              torch.tensor([len(d) for d in dets])),
              [[tuple(r) for r in g] for g in gts])
    np.testing.assert_allclose(float(m[0]), ev.eval(), rtol=1e-6)


def test_detection_map_state_accumulates():
    """A second batch with HasState 1 and the first batch's accumulated
    state gives the mAP of both batches in one call."""
    rng = np.random.RandomState(11)
    g1, g2 = _ground_truth(rng, 2, 4), _ground_truth(rng, 3, 4)
    d1, d2 = _detections(rng, g1, 4), _detections(rng, g2, 4)
    attrs = {"class_num": 4, "overlap_threshold": 0.5}
    out = {"MAP": ["map"], "AccumPosCount": ["pc"], "AccumTruePos": ["tp"],
           "AccumFalsePos": ["fp"]}
    m1, pc, tp, fp = run_op(tfluid, "detection_map",
                            {"DetectRes": ["d"], "Label": ["g"]}, out,
                            attrs, {"d": d1, "g": g1}, lod=("d", "g"))

    def seqs(flat_lod):
        flat, (offsets,) = flat_lod
        return [flat[a:b] for a, b in zip(offsets[:-1], offsets[1:])]
    feeds = {"d": d2, "g": g2, "has": np.array([1], np.int32),
             "pc": pc, "tp": seqs(tp), "fp": seqs(fp)}
    inputs = {"DetectRes": ["d"], "Label": ["g"], "HasState": ["has"],
              "PosCount": ["pc"], "TruePos": ["tp"], "FalsePos": ["fp"]}
    both = op_both("detection_map", inputs, {"MAP": ["map"]}, attrs, feeds,
                   lod=("d", "g", "tp", "fp"))
    (whole,) = run_op(tfluid, "detection_map",
                      {"DetectRes": ["d"], "Label": ["g"]},
                      {"MAP": ["map"]}, attrs, {"d": d1 + d2, "g": g1 + g2},
                      lod=("d", "g"))
    np.testing.assert_allclose(both[0], whole, rtol=1e-6)
