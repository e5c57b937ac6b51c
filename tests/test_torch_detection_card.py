"""The SSD op family on the card against the same ops on the CPU (``-m
cuda``, skipped without a card): every output lies on the device the
inputs were fed to (no detection op copies to the host), integer outputs
and multiclass_nms's kept rows equal the CPU's exactly, float outputs
within 1e-6 of the largest element (TF32 off). This file imports no JAX,
so that the card cases run where there is none."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid


def _boxes(rng, n):
    p1 = rng.rand(n, 2) * 0.6
    return np.concatenate([p1, p1 + rng.rand(n, 2) * 0.3 + 0.05],
                          axis=1).astype("float32")


def _cases():
    rng = np.random.RandomState(0)
    return {
        "iou_similarity": ({"X": ["x"], "Y": ["y"]}, {"Out": ["o"]}, {},
                           {"x": _boxes(rng, 9), "y": _boxes(rng, 30)}),
        "prior_box": ({"Input": ["f"], "Image": ["i"]},
                      {"Boxes": ["b"], "Variances": ["v"]},
                      {"min_sizes": [30.0], "max_sizes": [60.0],
                       "aspect_ratios": [2.0, 3.0], "flip": True,
                       "clip": True},
                      {"f": np.zeros((1, 2, 19, 19), "float32"),
                       "i": np.zeros((1, 3, 300, 300), "float32")}),
        "box_coder": ({"PriorBox": ["p"], "PriorBoxVar": ["pv"],
                       "TargetBox": ["t"]}, {"OutputBox": ["o"]},
                      {"code_type": "decode_center_size"},
                      {"p": _boxes(rng, 40),
                       "pv": np.full((40, 4), 0.1, "float32"),
                       "t": rng.normal(0, 1, (3, 40, 4)).astype("float32")}),
        "bipartite_match": ({"DistMat": ["d"]},
                            {"ColToRowMatchIndices": ["m"],
                             "ColToRowMatchDist": ["md"]},
                            {"match_type": "per_prediction",
                             "dist_threshold": 0.5},
                            {"d": rng.rand(4, 5, 60).astype("float32")}),
        "mine_hard_examples": ({"ClsLoss": ["l"], "MatchIndices": ["m"]},
                               {"NegMask": ["n"],
                                "UpdatedMatchIndices": ["u"]},
                               {"neg_pos_ratio": 3.0},
                               {"l": rng.rand(4, 60).astype("float32"),
                                "m": np.where(rng.rand(4, 60) < 0.1, 0, -1)
                                .astype(np.int32)}),
        "multiclass_nms": ({"BBoxes": ["b"], "Scores": ["s"]},
                           {"Out": ["o"]},
                           {"background_label": 0, "score_threshold": 0.05,
                            "nms_top_k": 40, "keep_top_k": 50,
                            "nms_threshold": 0.45, "nms_eta": 0.9},
                           {"b": np.stack([_boxes(rng, 60)] * 3),
                            "s": rng.rand(3, 6, 60).astype("float32")}),
        "roi_pool": ({"X": ["x"], "ROIs": ["r"]}, {"Out": ["o"]},
                     {"pooled_height": 3, "pooled_width": 3,
                      "spatial_scale": 0.5},
                     {"x": rng.rand(2, 4, 12, 12).astype("float32"),
                      "r": np.array([[0, 1, 2, 15, 20], [1, 0, 0, 23, 23]],
                                    "float32")}),
    }


def _run(place, op_type, ins, outs, attrs, feeds):
    prog = fluid.Program()
    block = prog.global_block()
    for name, arr in feeds.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
    names = [n for ns in outs.values() for n in ns]
    for n in names:
        block.create_var(name=n)
    block.append_op(op_type, ins, outs, attrs)
    return fluid.Executor(place).run(prog, feed=feeds, fetch_list=names,
                                     scope=fluid.Scope(),
                                     return_numpy=False)


@pytest.mark.cuda
@pytest.mark.parametrize("op_type", sorted(_cases()))
def test_detection_op_on_the_device_equals_the_cpu(op_type):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_detection_card.py on the GPU "
                    "machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = _cases()[op_type]
    got = _run(fluid.CUDAPlace(0), op_type, *args)
    want = _run(fluid.CPUPlace(), op_type, *args)
    for g, w in zip(got, want):
        if isinstance(w, fluid.LoDArray):
            assert g.data.device.type == g.lens.device.type == "cuda"
            assert torch.equal(g.lens.cpu(), w.lens)
            g, w = g.data, w.data
        assert g.device.type == "cuda" and g.dtype == w.dtype
        g = g.cpu()
        if w.is_floating_point():
            scale = float(w.abs().max()) if w.numel() else 0.0
            assert float((g - w).abs().max()) <= 1e-6 * scale + 1e-12, \
                op_type
        else:
            assert torch.equal(g, w), op_type
