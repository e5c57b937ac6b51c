"""The breadth ops of paddle_tpu/ops/breadth_ops.py with their grads:
expand, pad, crop, label_smooth, minus, l1_norm, conv_shift,
modified_huber_loss, uniform/gaussian_random_batch_size_like,
conv3d_transpose, max_pool3d_with_index, positive_negative_pair,
average_accumulates and detection_map. Plain PyTorch.

The random ops draw from the executor's generator, as dropout does. The
grads are the reference's closed forms, or the vector-Jacobian product of
the forward through autograd (``common.vjp``) where the reference takes
``jax.vjp``. detection_map is a host op, as the reference's is (its kernel
is CPU-only there too): it reads its LoD inputs to the host, computes the
mAP in numpy and puts its outputs back on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.amp import cast_compute
from ..core.lod import LoDArray
from ..core.registry import register_op, infer_output, same_shape, OpSpec, G
from ..core.types import torch_dtype
from .common import data_of, like, vjp


# ---------------------------------------------------------------------------
# expand
# ---------------------------------------------------------------------------

def _expand_infer(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        return
    times = op.attrs.get("expand_times", [1] * len(x.shape))
    infer_output(op, block, "Out",
                 tuple(int(s * t) for s, t in zip(x.shape, times)),
                 dtype=x.dtype)


@register_op("expand", infer_shape=_expand_infer, grad=lambda op: [OpSpec(
    "expand_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def expand(ctx):
    """expand_op.h: X tiled ``expand_times`` along each dim."""
    x = data_of(ctx.input("X"))
    ctx.set_output("Out", x.repeat(*[int(t) for t in
                                     ctx.attr("expand_times")]))


@register_op("expand_grad")
def expand_grad(ctx):
    """The tiles of Out@GRAD summed back onto X's shape."""
    x = data_of(ctx.input("X"))
    dy = data_of(ctx.input("Out@GRAD"))
    split = []
    for t, s in zip(ctx.attr("expand_times"), x.shape):
        split += [int(t), s]
    ctx.set_output("X@GRAD", dy.reshape(split).sum(
        dim=tuple(range(0, len(split), 2))))


# ---------------------------------------------------------------------------
# pad
# ---------------------------------------------------------------------------

def _pad_pairs(ctx_attr, ndim):
    flat = [int(p) for p in ctx_attr("paddings")]
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(ndim)]


def _pad_infer(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        return
    flat = op.attrs.get("paddings", [])
    shape = tuple(int(s + flat[2 * i] + flat[2 * i + 1])
                  for i, s in enumerate(x.shape))
    infer_output(op, block, "Out", shape, dtype=x.dtype)


@register_op("pad", infer_shape=_pad_infer, grad=lambda op: [OpSpec(
    "pad_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def pad(ctx):
    """pad_op.cc: each dim widened by its (before, after) pair, the new
    cells ``pad_value``."""
    x = data_of(ctx.input("X"))
    pairs = _pad_pairs(ctx.attr, x.ndim)
    flat = [p for pair in reversed(pairs) for p in pair]
    ctx.set_output("Out", torch.nn.functional.pad(
        x, flat, value=float(ctx.attr("pad_value", 0.0))))


@register_op("pad_grad")
def pad_grad(ctx):
    x = data_of(ctx.input("X"))
    dy = data_of(ctx.input("Out@GRAD"))
    pairs = _pad_pairs(ctx.attr, x.ndim)
    sl = tuple(slice(b, b + s) for (b, _), s in zip(pairs, x.shape))
    ctx.set_output("X@GRAD", dy[sl])


# ---------------------------------------------------------------------------
# crop
# ---------------------------------------------------------------------------

def _crop_infer(op, block):
    if op.attrs.get("shape"):
        x = block.var(op.input("X")[0])
        infer_output(op, block, "Out", tuple(op.attrs["shape"]),
                     dtype=x.dtype)


@register_op("crop", infer_shape=_crop_infer, grad=lambda op: [OpSpec(
    "crop_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def crop(ctx):
    """crop_op.h: the window of ``shape`` at ``offsets`` (the shape
    borrowed from input Y when given). A -1 entry takes the rest of that
    dim past its offset."""
    x = data_of(ctx.input("X"))
    if ctx.has_input("Y"):
        shape = tuple(data_of(ctx.input("Y")).shape)
    else:
        shape = tuple(int(s) for s in ctx.attr("shape"))
    offsets = [int(o) for o in ctx.attr("offsets", [0] * x.ndim)]
    sl = tuple(slice(o, xs if s == -1 else o + s)
               for s, xs, o in zip(shape, x.shape, offsets))
    ctx.set_output("Out", x[sl])


@register_op("crop_grad")
def crop_grad(ctx):
    x = data_of(ctx.input("X"))
    dy = data_of(ctx.input("Out@GRAD"))
    offsets = [int(o) for o in ctx.attr("offsets", [0] * x.ndim)]
    dx = torch.zeros(x.shape, dtype=dy.dtype, device=dy.device)
    sl = tuple(slice(o, o + ds) for o, ds in zip(offsets, dy.shape))
    dx[sl] = dy
    ctx.set_output("X@GRAD", dx)


# ---------------------------------------------------------------------------
# positive_negative_pair
# ---------------------------------------------------------------------------

@register_op("positive_negative_pair")
def positive_negative_pair(ctx):
    """positive_negative_pair_op.h: over the in-batch pairs that share a
    QueryID and differ in label, the weight of the pairs the score orders
    as the label does (positive), against it (negative) and tied
    (neutral), a pair weighing the mean of its two weights; added onto
    the Accumulate* inputs when given. A tied pair counts as neutral only,
    as in the reference's lowering."""
    score = data_of(ctx.input("Score"))
    label = data_of(ctx.input("Label")).reshape(-1)
    query = data_of(ctx.input("QueryID")).reshape(-1)
    col = int(ctx.attr("column", -1))
    s = score[:, col].reshape(-1)
    n = s.shape[0]
    w = data_of(ctx.input("Weight")).reshape(-1) \
        if ctx.has_input("Weight") \
        else torch.ones((n,), dtype=torch.float32, device=s.device)

    same_query = query[:, None] == query[None, :]
    diff_label = label[:, None] != label[None, :]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=s.device), diagonal=1)
    eligible = same_query & diff_label & upper
    pw = (w[:, None] + w[None, :]) * 0.5
    concord = (s[:, None] - s[None, :]) * (label[:, None] - label[None, :]) \
        > 0
    tied = s[:, None] == s[None, :]
    zero = torch.zeros((), dtype=pw.dtype, device=pw.device)
    pos = torch.where(eligible & ~tied & concord, pw, zero).sum()
    neg = torch.where(eligible & ~tied & ~concord, pw, zero).sum()
    neu = torch.where(eligible & tied, pw, zero).sum()
    for slot, val in (("PositivePair", pos), ("NegativePair", neg),
                      ("NeutralPair", neu)):
        acc = "Accumulate" + slot
        if ctx.has_input(acc):
            val = val + data_of(ctx.input(acc)).reshape(())
        ctx.set_output(slot, val.reshape((1,)))


# ---------------------------------------------------------------------------
# label_smooth, minus, l1_norm
# ---------------------------------------------------------------------------

@register_op("label_smooth", infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "label_smooth_grad", {"Out@GRAD": G(op.output("Out"))},
                 {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def label_smooth(ctx):
    """label_smooth_op.h: (1-ε)·x + ε·prior, the prior uniform
    (1/classes) without a PriorDist input."""
    x = data_of(ctx.input("X"))
    eps = ctx.attr("epsilon", 0.0)
    if ctx.has_input("PriorDist"):
        prior = data_of(ctx.input("PriorDist")).reshape(-1)
        out = (1.0 - eps) * x + eps * prior
    else:
        out = (1.0 - eps) * x + eps / x.shape[-1]
    ctx.set_output("Out", out.to(x.dtype))


@register_op("label_smooth_grad")
def label_smooth_grad(ctx):
    dy = data_of(ctx.input("Out@GRAD"))
    ctx.set_output("X@GRAD", (1.0 - ctx.attr("epsilon", 0.0)) * dy)


@register_op("minus", infer_shape=same_shape("X", "Out"), grad=lambda op: [
    OpSpec("scale", {"X": G(op.output("Out"))}, {"Out": G(op.input("X"))},
           {"scale": 1.0}),
    OpSpec("scale", {"X": G(op.output("Out"))}, {"Out": G(op.input("Y"))},
           {"scale": -1.0})])
def minus(ctx):
    """minus_op.cc: Out = X - Y; the grads are the reference's pair of
    scale ops (+1, -1)."""
    x, y = data_of(ctx.input("X")), data_of(ctx.input("Y"))
    ctx.set_output("Out", like(ctx.input("X"), x - y))


@register_op("l1_norm", grad=lambda op: [OpSpec(
    "l1_norm_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))})])
def l1_norm(ctx):
    """l1_norm_op.h: the scalar Σ|x|."""
    x = data_of(ctx.input("X"))
    ctx.set_output("Out", torch.abs(x).sum().reshape(()))


@register_op("l1_norm_grad")
def l1_norm_grad(ctx):
    x = data_of(ctx.input("X"))
    dy = data_of(ctx.input("Out@GRAD")).reshape(())
    ctx.set_output("X@GRAD", torch.sign(x) * dy)


# ---------------------------------------------------------------------------
# conv_shift (circular correlation)
# ---------------------------------------------------------------------------

def _conv_shift_compute(x, y):
    """out[b, i] = Σ_j x[b, (i + j - M//2) mod W] · y[b, j]
    (conv_shift_op.cu:84-95), one roll of x per tap."""
    half = y.shape[1] // 2
    out = torch.roll(x, half, dims=1) * y[:, 0:1]
    for j in range(1, y.shape[1]):
        out = out + torch.roll(x, half - j, dims=1) * y[:, j:j + 1]
    return out


@register_op("conv_shift", infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "conv_shift_grad",
                 {"X": op.input("X"), "Y": op.input("Y"),
                  "Out@GRAD": G(op.output("Out"))},
                 {"X@GRAD": G(op.input("X")), "Y@GRAD": G(op.input("Y"))})])
def conv_shift(ctx):
    ctx.set_output("Out", _conv_shift_compute(data_of(ctx.input("X")),
                                              data_of(ctx.input("Y"))))


@register_op("conv_shift_grad")
def conv_shift_grad(ctx):
    dx, dy = vjp(_conv_shift_compute, (data_of(ctx.input("X")),
                                       data_of(ctx.input("Y"))),
                 data_of(ctx.input("Out@GRAD")))
    ctx.set_output("X@GRAD", dx)
    ctx.set_output("Y@GRAD", dy)


# ---------------------------------------------------------------------------
# modified_huber_loss
# ---------------------------------------------------------------------------

@register_op("modified_huber_loss", grad=lambda op: [OpSpec(
    "modified_huber_loss_grad",
    {"Y": op.input("Y"), "IntermediateVal": op.output("IntermediateVal"),
     "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))})])
def modified_huber_loss(ctx):
    """modified_huber_loss_op.h: inter = x·(2y-1) for y in {0, 1}; the
    loss -4·inter below -1, (1-inter)² below 1, else 0."""
    x = data_of(ctx.input("X"))
    y = data_of(ctx.input("Y"))
    inter = x.reshape(-1) * (2.0 * y.reshape(-1) - 1.0)
    zero = torch.zeros((), dtype=inter.dtype, device=inter.device)
    loss = torch.where(inter < -1.0, -4.0 * inter,
                       torch.where(inter < 1.0, torch.square(1.0 - inter),
                                   zero))
    ctx.set_output("IntermediateVal", inter.reshape(x.shape))
    ctx.set_output("Out", loss.reshape(x.shape))


@register_op("modified_huber_loss_grad")
def modified_huber_loss_grad(ctx):
    y = data_of(ctx.input("Y"))
    inter = data_of(ctx.input("IntermediateVal")).reshape(-1)
    dy = data_of(ctx.input("Out@GRAD")).reshape(-1)
    sign = 2.0 * y.reshape(-1) - 1.0
    zero = torch.zeros((), dtype=inter.dtype, device=inter.device)
    dx = torch.where(inter < -1.0, -4.0 * sign * dy,
                     torch.where(inter < 1.0,
                                 -2.0 * (1.0 - inter) * sign * dy, zero))
    ctx.set_output("X@GRAD", dx.reshape(y.shape))


# ---------------------------------------------------------------------------
# uniform/gaussian_random_batch_size_like (batch_size_like.h)
# ---------------------------------------------------------------------------

def _batch_size_like_shape(ctx):
    ref = data_of(ctx.input("Input"))
    shape = [int(s) for s in ctx.attr("shape")]
    shape[int(ctx.attr("output_dim_idx", 0))] = \
        ref.shape[int(ctx.attr("input_dim_idx", 0))]
    return tuple(shape)


@register_op("uniform_random_batch_size_like")
def uniform_random_batch_size_like(ctx):
    """Uniform draws in [min, max) of ``shape`` with the batch dim taken
    from Input, from the executor's generator."""
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    out = torch.rand(_batch_size_like_shape(ctx), generator=ctx.generator(),
                     dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (out * (hi - lo) + lo).to(
        torch_dtype(ctx.attr("dtype", "float32"))))


@register_op("gaussian_random_batch_size_like")
def gaussian_random_batch_size_like(ctx):
    """Normal draws (mean, std) of ``shape`` with the batch dim taken from
    Input, from the executor's generator."""
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    out = torch.randn(_batch_size_like_shape(ctx), generator=ctx.generator(),
                      dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (mean + std * out).to(
        torch_dtype(ctx.attr("dtype", "float32"))))


# ---------------------------------------------------------------------------
# conv3d_transpose
# ---------------------------------------------------------------------------

def triple(v):
    if isinstance(v, (list, tuple)):
        v = list(v) + [v[-1]] * (3 - len(v))
        return tuple(int(i) for i in v[:3])
    return (int(v),) * 3


def _conv3d_transpose_compute(x, w, strides, paddings, dilations):
    """conv_transpose_op.cc's 3-D form, the filter [C_in, C_out, kd, kh,
    kw], on bfloat16 operands under AMP (reference :336)."""
    x, w = cast_compute(x, w)
    return F.conv_transpose3d(x, w.to(x.dtype), stride=strides,
                              padding=paddings, dilation=dilations)


def _conv3d_transpose_infer(op, block):
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    if x.shape is None or w.shape is None:
        return
    s = triple(op.attrs.get("strides", [1, 1, 1]))
    p = triple(op.attrs.get("paddings", [0, 0, 0]))
    d = triple(op.attrs.get("dilations", [1, 1, 1]))
    spatial = tuple(
        (x.shape[2 + i] - 1) * s[i] - 2 * p[i]
        + (d[i] * (w.shape[2 + i] - 1) + 1) for i in range(3))
    infer_output(op, block, "Output", (x.shape[0], w.shape[1]) + spatial,
                 dtype=x.dtype)


def _conv3d_transpose_args(attr):
    return (triple(attr("strides", [1, 1, 1])),
            triple(attr("paddings", [0, 0, 0])),
            triple(attr("dilations", [1, 1, 1])))


@register_op("conv3d_transpose", infer_shape=_conv3d_transpose_infer,
             grad=lambda op: [OpSpec(
                 "conv3d_transpose_grad",
                 {"Input": op.input("Input"), "Filter": op.input("Filter"),
                  "Output@GRAD": G(op.output("Output"))},
                 {"Input@GRAD": G(op.input("Input")),
                  "Filter@GRAD": G(op.input("Filter"))},
                 dict(op.attrs))])
def conv3d_transpose(ctx):
    ctx.set_output("Output", _conv3d_transpose_compute(
        data_of(ctx.input("Input")), data_of(ctx.input("Filter")),
        *_conv3d_transpose_args(ctx.attr)))


@register_op("conv3d_transpose_grad")
def conv3d_transpose_grad(ctx):
    args = _conv3d_transpose_args(ctx.attr)
    dx, dw = vjp(lambda a, b: _conv3d_transpose_compute(a, b, *args),
                 (data_of(ctx.input("Input")), data_of(ctx.input("Filter"))),
                 data_of(ctx.input("Output@GRAD")))
    ctx.set_output("Input@GRAD", dx)
    ctx.set_output("Filter@GRAD", dw)


# ---------------------------------------------------------------------------
# max_pool3d_with_index
# ---------------------------------------------------------------------------

@register_op("max_pool3d_with_index")
def max_pool3d_with_index(ctx):
    """pool_with_index_op.cc's 3-D form: Mask holds each window's argmax
    as a flat offset into the unpadded [D, H, W] volume, the first maximum
    of the window in (d, h, w) order. Padding is -inf, so the maximum never
    lands on it; global_pooling takes the whole volume."""
    x = data_of(ctx.input("X"))
    _, _, dd, h, w = x.shape
    ks = triple(ctx.attr("ksize"))
    pd = triple(ctx.attr("paddings", [0, 0, 0]))
    if ctx.attr("global_pooling", False):
        ks, pd = (dd, h, w), (0, 0, 0)
    st = triple(ctx.attr("strides", ks))
    xp = F.pad(x, (pd[2], pd[2], pd[1], pd[1], pd[0], pd[0]),
               value=float("-inf")) if any(pd) else x
    od = (dd + 2 * pd[0] - ks[0]) // st[0] + 1
    oh = (h + 2 * pd[1] - ks[1]) // st[1] + 1
    ow = (w + 2 * pd[2] - ks[2]) // st[2] + 1
    patches = torch.stack([
        xp[:, :, a:a + st[0] * od:st[0], b:b + st[1] * oh:st[1],
           e:e + st[2] * ow:st[2]]
        for a in range(ks[0]) for b in range(ks[1]) for e in range(ks[2])],
        dim=-1)
    arg = torch.argmax(patches, dim=-1)
    dev = x.device
    ds = torch.arange(od, device=dev)[:, None, None] * st[0] \
        + arg // (ks[1] * ks[2]) - pd[0]
    hs = torch.arange(oh, device=dev)[None, :, None] * st[1] \
        + (arg // ks[2]) % ks[1] - pd[1]
    ws = torch.arange(ow, device=dev)[None, None, :] * st[2] \
        + arg % ks[2] - pd[2]
    ctx.set_output("Out", patches.amax(dim=-1))
    ctx.set_output("Mask", ((ds * h + hs) * w + ws).to(torch.int32))


# ---------------------------------------------------------------------------
# average_accumulates (the ParamAverage windows)
# ---------------------------------------------------------------------------

_MAX_NUM_ACCUMULATES = 16384  # average_accumulates_op.h kMaxNumAccumulates


@register_op("average_accumulates")
def average_accumulates(ctx):
    """average_accumulates_op.h: Polyak-average sums of a parameter over a
    sliding window. sum_1 takes every step; every 16384 updates it folds
    into sum_2; when the window reaches max(min_average_window,
    min(max_average_window, num_updates · average_window)) everything
    folds into sum_3 and restarts. Both folds read the step's incoming
    sums, so the fold step's own parameter enters no sum (the reference's
    order). The counts are int64, as Paddle declares them."""
    param = data_of(ctx.input("param"))
    s1 = data_of(ctx.input("in_sum_1"))
    s2 = data_of(ctx.input("in_sum_2"))
    s3 = data_of(ctx.input("in_sum_3"))

    def count(slot):
        return data_of(ctx.input(slot)).reshape(()).to(torch.int64)
    num_updates = count("in_num_updates") + 1
    num_acc = count("in_num_accumulates") + 1
    old_num_acc = count("in_old_num_accumulates")

    avg_window = ctx.attr("average_window", 0.0)
    int_max = np.iinfo(np.int32).max
    max_w = min(int(ctx.attr("max_average_window", int_max)), int_max)
    min_w = min(int(ctx.attr("min_average_window", 10000)), max_w)

    in_s1, in_s2 = s1, s2
    s1 = s1 + param
    zero = torch.zeros_like(s1)
    fold2 = (num_updates % _MAX_NUM_ACCUMULATES) == 0
    s2 = torch.where(fold2, in_s2 + in_s1, s2)
    s1 = torch.where(fold2, zero, s1)
    window = (num_updates.to(torch.float32) * avg_window).to(torch.int64)
    full = (num_acc >= min_w) & (num_acc >= torch.clamp_max(window, max_w))
    s3 = torch.where(full, in_s1 + in_s2, s3)
    s1 = torch.where(full, zero, s1)
    s2 = torch.where(full, zero, s2)
    old_num_acc = torch.where(full, num_acc, old_num_acc)
    num_acc = torch.where(full, torch.zeros_like(num_acc), num_acc)
    for slot, v in (("out_sum_1", s1), ("out_sum_2", s2), ("out_sum_3", s3)):
        ctx.set_output(slot, v)
    for slot, v in (("out_num_updates", num_updates),
                    ("out_num_accumulates", num_acc),
                    ("out_old_num_accumulates", old_num_acc)):
        ctx.set_output(slot, v.reshape((1,)))


# ---------------------------------------------------------------------------
# detection_map (the op form of the mAP evaluator; a host op)
# ---------------------------------------------------------------------------

def _host_rows(v):
    """Each sequence's rows of a LoD input as numpy arrays (a plain tensor
    is one sequence)."""
    data = data_of(v).detach().cpu().numpy()
    if isinstance(v, LoDArray):
        lens = v.lens.detach().cpu().numpy().reshape(-1)
        return [data[i][:int(n)] for i, n in enumerate(lens)]
    return [data.reshape(-1, data.shape[-1])]


def _box_iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) \
        - inter
    return inter / ua if ua > 0 else 0.0


def average_precision(tps, fps, n_pos, ap_type):
    """11-point or integral AP of score-descending tp/fp flags against
    ``n_pos`` positives (detection_map_op.h GetMAP)."""
    if n_pos == 0 or len(tps) == 0:
        return 0.0
    acc_tp, acc_fp = np.cumsum(tps), np.cumsum(fps)
    precision = acc_tp / np.maximum(acc_tp + acc_fp, 1e-12)
    recall = acc_tp / n_pos
    if ap_type == "11point":
        max_precisions = np.zeros(11)
        start = len(tps) - 1
        for j in range(10, -1, -1):
            for i in range(start, -1, -1):
                if recall[i] < j / 10.0:
                    start = i
                    if j > 0:
                        max_precisions[j - 1] = max_precisions[j]
                    break
                if max_precisions[j] < precision[i]:
                    max_precisions[j] = precision[i]
        return float(max_precisions.sum() / 11.0)
    ap, prev = 0.0, 0.0
    for i in range(len(tps)):
        ap += precision[i] * (recall[i] - prev)
        prev = recall[i]
    return float(ap)


def _match_detections(dets, gts, overlap_t, evaluate_difficult, pos_count,
                      true_pos, false_pos):
    """One image's detections against its ground truth (detection_map_op.h
    CalcTrueAndFalsePositive): by descending score each detection takes
    the unmatched ground truth of its class it overlaps most, above
    ``overlap_t``; a second hit on one ground truth is a false
    positive."""
    g_label = gts[:, 0].astype(int)
    if gts.shape[1] == 6:
        g_diff, g_box = gts[:, 1].astype(bool), gts[:, 2:6]
    else:
        g_diff, g_box = np.zeros(len(gts), bool), gts[:, 1:5]
    for c in np.unique(g_label):
        pos_count[int(c)] += int(np.sum((g_label == c)
                                        & (evaluate_difficult | ~g_diff)))
    matched = np.zeros(len(gts), bool)
    for i in np.argsort(-dets[:, 1]):
        c, score = int(dets[i, 0]), float(dets[i, 1])
        best, best_j = 0.0, -1
        for j in np.where(g_label == c)[0]:
            iou = _box_iou(dets[i, 2:6], g_box[j])
            if iou > best:
                best, best_j = iou, j
        if best > overlap_t:
            if not evaluate_difficult and g_diff[best_j]:
                continue
            tp = not matched[best_j]
            matched[best_j] = True
        else:
            tp = False
        true_pos[c].append((score, int(tp)))
        false_pos[c].append((score, int(not tp)))


@register_op("detection_map")
def detection_map(ctx):
    """detection_map_op.cc: the mAP of DetectRes (LoD rows of label,
    score, x1, y1, x2, y2) against Label (LoD rows of label, x1, y1, x2,
    y2, or label, difficult, box), merged with the PosCount / TruePos /
    FalsePos state where HasState is given and nonzero; MAP and the
    accumulated state out. A class without ground truth or without a
    detection is left out of the mean. Computed on the host, like the
    reference's CPU-only kernel."""
    det = ctx.input("DetectRes")
    class_num = int(ctx.attr("class_num"))
    dev = data_of(det).device
    pos_count = np.zeros(class_num, np.int64)
    true_pos = {c: [] for c in range(class_num)}
    false_pos = {c: [] for c in range(class_num)}
    for dets, gts in zip(_host_rows(det), _host_rows(ctx.input("Label"))):
        _match_detections(dets, gts,
                          float(ctx.attr("overlap_threshold", 0.5)),
                          bool(ctx.attr("evaluate_difficult", True)),
                          pos_count, true_pos, false_pos)

    has_state = ctx.has_input("HasState") and int(
        data_of(ctx.input("HasState")).reshape(-1)[0]) != 0
    if ctx.has_input("PosCount") and has_state:
        prev = data_of(ctx.input("PosCount")).cpu().numpy().reshape(-1)
        pos_count[:len(prev)] += prev.astype(np.int64)
        for slot, store in (("TruePos", true_pos), ("FalsePos", false_pos)):
            v = ctx.input(slot)
            rows = data_of(v).cpu().numpy()
            lens = v.lens.cpu().numpy().reshape(-1) \
                if isinstance(v, LoDArray) \
                else np.full(rows.shape[0], rows.shape[1], np.int64)
            for c, n in enumerate(lens):
                store.setdefault(c, []).extend(
                    (float(s), int(f)) for s, f in rows[c][:int(n)])

    ap_type = ctx.attr("ap_type", "integral")
    aps = []
    for c in range(class_num):
        if pos_count[c] == 0 or not true_pos[c]:
            continue
        tps = np.asarray([e[1] for e in sorted(true_pos[c],
                                                key=lambda e: -e[0])])
        fps = np.asarray([e[1] for e in sorted(false_pos[c],
                                                key=lambda e: -e[0])])
        aps.append(average_precision(tps, fps, int(pos_count[c]), ap_type))
    m_ap = sum(aps) / len(aps) if aps else 0.0

    def pack(store):
        width = max([len(v) for v in store.values()] + [1])
        arr = np.zeros((class_num, width, 2), np.float32)
        lens = np.zeros(class_num, np.int32)
        for c, v in store.items():
            lens[c] = len(v)
            for i, e in enumerate(sorted(v, key=lambda e: -e[0])):
                arr[c, i] = e
        return LoDArray(torch.from_numpy(arr).to(dev),
                        torch.from_numpy(lens).to(dev))

    ctx.set_output("MAP", torch.tensor([m_ap], dtype=torch.float32,
                                       device=dev))
    ctx.set_output("AccumPosCount", torch.from_numpy(
        pos_count.astype(np.int32)).reshape(-1, 1).to(dev))
    ctx.set_output("AccumTruePos", pack(true_pos))
    ctx.set_output("AccumFalsePos", pack(false_pos))
