"""The rest of paddle_tpu/ops/misc_ops.py, each op with its grad: cumsum,
prelu, maxout, spp, max_pool2d_with_index, unpool, norm, im2sequence,
rank_loss, margin_rank_loss, bilinear_tensor_product, is_empty, nce,
conv3d and pool3d.

Plain PyTorch, as the reference's are plain jnp. Each grad is the
vector-Jacobian product of the forward's math through autograd
(``common.vjp``), as the reference's are ``jax.vjp`` of theirs, except
where the reference writes a closed form (prelu, unpool, rank_loss,
margin_rank_loss), which the port keeps. conv3d casts its operands to
bfloat16 under AMP (reference :546).

nce draws its negatives from the executor's generator, or takes
``custom_neg_classes`` (the reference's test hook, and the way two
packages give the same samples). The drawn samples are the op's
SampleLabels output, which nce_grad reads, so the cost and the gradient
describe the same sampled loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.amp import cast_compute
from ..core.lod import LoDArray
from ..core.registry import register_op, infer_output, same_shape, OpSpec, G
from .breadth_ops import triple
from .common import data_of, like, vjp
from .conv_ops import pool2d_compute


# ---------------------------------------------------------------------------
# maxout
# ---------------------------------------------------------------------------

def _maxout_infer(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        return
    g = int(op.attrs["groups"])
    n, c, h, w = x.shape
    infer_output(op, block, "Out", (n, c // g, h, w), dtype=x.dtype)


def _maxout_compute(x, groups):
    n, c, h, w = x.shape
    return x.reshape(n, c // groups, groups, h, w).amax(dim=2)


@register_op("maxout", infer_shape=_maxout_infer, grad=lambda op: [OpSpec(
    "maxout_grad",
    {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def maxout(ctx):
    """maxout_op.cc: the channels in groups of ``groups``, the max over
    each group (NCHW)."""
    x = data_of(ctx.input("X"))
    ctx.set_output("Out", _maxout_compute(x, int(ctx.attr("groups"))))


@register_op("maxout_grad")
def maxout_grad(ctx):
    x = data_of(ctx.input("X"))
    g = int(ctx.attr("groups"))
    ctx.set_output("X@GRAD", vjp(lambda a: _maxout_compute(a, g), [x],
                                 data_of(ctx.input("Out@GRAD")))[0])


# ---------------------------------------------------------------------------
# im2sequence
# ---------------------------------------------------------------------------

def _im2seq_compute(x, kernels, strides, paddings):
    n, c, h, w = x.shape
    kh, kw = kernels
    sh, sw = strides
    pu, pl, pd, pr = paddings          # up, left, down, right
    oh = (h + pu + pd - kh) // sh + 1
    ow = (w + pl + pr - kw) // sw + 1
    xp = torch.nn.functional.pad(x, (pl, pr, pu, pd))
    patches = torch.stack([
        xp[:, :, i:i + sh * oh:sh, j:j + sw * ow:sw]
        for i in range(kh) for j in range(kw)], dim=2)  # [N,C,kh*kw,oh,ow]
    # a step is one [c, kh, kw] patch flattened; steps run row-major
    seq = patches.reshape(n, c, kh, kw, oh, ow).permute(0, 4, 5, 1, 2, 3)
    return seq.reshape(n, oh * ow, c * kh * kw), oh * ow


def _im2seq_args(ctx):
    return (tuple(ctx.attr("kernels")), tuple(ctx.attr("strides", [1, 1])),
            tuple(ctx.attr("paddings", [0, 0, 0, 0])))


@register_op("im2sequence", grad=lambda op: [OpSpec(
    "im2sequence_grad",
    {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def im2sequence(ctx):
    """im2sequence_op.h: each image becomes one sequence of oh*ow steps,
    each step a flattened [c, kh, kw] patch."""
    x = data_of(ctx.input("X"))
    seq, steps = _im2seq_compute(x, *_im2seq_args(ctx))
    lens = torch.full((x.shape[0],), steps, dtype=torch.int32,
                      device=x.device)
    ctx.set_output("Out", LoDArray(seq, lens))


@register_op("im2sequence_grad")
def im2sequence_grad(ctx):
    x = data_of(ctx.input("X"))
    args = _im2seq_args(ctx)
    ctx.set_output("X@GRAD", vjp(lambda a: _im2seq_compute(a, *args)[0],
                                 [x], data_of(ctx.input("Out@GRAD")))[0])


# ---------------------------------------------------------------------------
# rank_loss
# ---------------------------------------------------------------------------

@register_op("rank_loss", infer_shape=same_shape("Left", "Out"),
             grad=lambda op: [OpSpec(
                 "rank_loss_grad",
                 {"Label": op.input("Label"), "Left": op.input("Left"),
                  "Right": op.input("Right"),
                  "Out@GRAD": G(op.output("Out"))},
                 {"Left@GRAD": G(op.input("Left")),
                  "Right@GRAD": G(op.input("Right"))})])
def rank_loss(ctx):
    """rank_loss_op.h: RankNet's pairwise loss
    log(1 + e^{l-r}) - label·(l-r)."""
    label = data_of(ctx.input("Label"))
    d = data_of(ctx.input("Left")) - data_of(ctx.input("Right"))
    ctx.set_output("Out", torch.log1p(torch.exp(d)) - label * d)


@register_op("rank_loss_grad")
def rank_loss_grad(ctx):
    label = data_of(ctx.input("Label"))
    left = data_of(ctx.input("Left"))
    right = data_of(ctx.input("Right"))
    d = data_of(ctx.input("Out@GRAD"))
    sig = torch.sigmoid(left - right)
    ctx.set_output("Left@GRAD", d * (sig - label))
    ctx.set_output("Right@GRAD", d * (label - sig))


# ---------------------------------------------------------------------------
# nce (noise-contrastive estimation)
# ---------------------------------------------------------------------------

def _nce_grad_maker(op):
    bias = bool(op.input("Bias"))
    inputs = {"Input": op.input("Input"), "Weight": op.input("Weight"),
              "SampleLabels": op.output("SampleLabels"),
              "Cost@GRAD": G(op.output("Cost"))}
    outputs = {"Input@GRAD": G(op.input("Input")),
               "Weight@GRAD": G(op.input("Weight"))}
    if bias:
        inputs["Bias"] = op.input("Bias")
        outputs["Bias@GRAD"] = G(op.input("Bias"))
    if op.input("SampleWeight"):
        inputs["SampleWeight"] = op.input("SampleWeight")
    return [OpSpec("nce_grad", inputs, outputs, dict(op.attrs))]


def _nce_cost(x, w, bias, samples, num_true, num_neg, num_classes,
              sample_weight):
    """Per sample, σ(x·w_c + b_c) over [true classes | negatives]; cost =
    Σ_true -log(o/(o+b)) + Σ_neg -log(b/(o+b)) with b = num_neg /
    num_classes, scaled by the sample's weight when given."""
    idx = samples.long()
    logits = torch.einsum("bd,bsd->bs", x, w[idx])
    if bias is not None:
        logits = logits + bias.reshape(-1)[idx]
    o = torch.sigmoid(logits)
    bconst = num_neg / num_classes
    true_cost = -torch.log(o[:, :num_true] / (o[:, :num_true] + bconst))
    neg_cost = -torch.log(bconst / (o[:, num_true:] + bconst))
    cost = true_cost.sum(dim=1) + neg_cost.sum(dim=1)
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1)
    return cost.reshape(-1, 1)


def _optional(ctx, slot):
    return data_of(ctx.input(slot)) if ctx.has_input(slot) else None


@register_op("nce", grad=_nce_grad_maker)
def nce(ctx):
    """nce_op.h. Negatives: ``custom_neg_classes`` when given, else
    uniform draws from the executor's generator; the samples, true labels
    first, are the SampleLabels output (int32)."""
    label = data_of(ctx.input("Label"))
    if label.ndim == 1:
        label = label[:, None]
    num_neg = int(ctx.attr("num_neg_samples"))
    num_classes = int(ctx.attr("num_total_classes"))
    custom = ctx.attr("custom_neg_classes", []) or []
    b = label.shape[0]
    if custom:
        neg = torch.tensor(custom, dtype=torch.int32,
                           device=label.device)[None, :].expand(b, -1)
    else:
        neg = torch.randint(0, num_classes, (b, num_neg),
                            generator=ctx.generator(), device=label.device,
                            dtype=torch.int64).to(torch.int32)
    samples = torch.cat([label.to(torch.int32), neg], dim=1)
    ctx.set_output("SampleLabels", samples)
    ctx.set_output("Cost", _nce_cost(
        data_of(ctx.input("Input")), data_of(ctx.input("Weight")),
        _optional(ctx, "Bias"), samples, label.shape[1], num_neg,
        num_classes, _optional(ctx, "SampleWeight")))


@register_op("nce_grad")
def nce_grad(ctx):
    """The vector-Jacobian product of the forward's cost, on the forward's
    own SampleLabels."""
    x = data_of(ctx.input("Input"))
    w = data_of(ctx.input("Weight"))
    bias = _optional(ctx, "Bias")
    samples = data_of(ctx.input("SampleLabels"))
    num_neg = int(ctx.attr("num_neg_samples"))
    num_classes = int(ctx.attr("num_total_classes"))
    custom = ctx.attr("custom_neg_classes", []) or []
    num_true = samples.shape[1] - (len(custom) or num_neg)
    sample_weight = _optional(ctx, "SampleWeight")
    primals = [x, w] + ([bias] if bias is not None else [])

    def f(a, b, *rest):
        return _nce_cost(a, b, rest[0] if rest else None, samples, num_true,
                         num_neg, num_classes, sample_weight)

    grads = vjp(f, primals, data_of(ctx.input("Cost@GRAD")).reshape(-1, 1))
    ctx.set_output("Input@GRAD", grads[0])
    ctx.set_output("Weight@GRAD", grads[1])
    if bias is not None:
        ctx.set_output("Bias@GRAD", grads[2])


# ---------------------------------------------------------------------------
# cumsum, prelu
# ---------------------------------------------------------------------------

@register_op("cumsum", infer_shape=same_shape("X", "Out"), grad=lambda op: [
    OpSpec("cumsum", {"X": G(op.output("Out"))}, {"Out": G(op.input("X"))},
           {**dict(op.attrs), "reverse": not op.attr("reverse", False)})])
def cumsum(ctx):
    """cum_op.h: the running sum along ``axis``, exclusive and reversed on
    request; the grad is cumsum with ``reverse`` flipped."""
    x = data_of(ctx.input("X"))
    axis = int(ctx.attr("axis", -1))
    reverse = bool(ctx.attr("reverse", False))
    v = torch.flip(x, (axis,)) if reverse else x
    out = torch.cumsum(v, dim=axis)
    if ctx.attr("exclusive", False):
        out = out - v
    if reverse:
        out = torch.flip(out, (axis,))
    ctx.set_output("Out", like(ctx.input("X"), out))


@register_op("prelu", infer_shape=same_shape("X", "Out"), grad=lambda op: [
    OpSpec("prelu_grad",
           {"X": op.input("X"), "Alpha": op.input("Alpha"),
            "Out@GRAD": G(op.output("Out"))},
           {"X@GRAD": G(op.input("X")), "Alpha@GRAD": G(op.input("Alpha"))})])
def prelu(ctx):
    """prelu_op.cc with one alpha (the reference's numel(Alpha) == 1)."""
    x = data_of(ctx.input("X"))
    alpha = data_of(ctx.input("Alpha")).reshape(())
    ctx.set_output("Out", like(ctx.input("X"),
                               torch.where(x > 0, x, alpha * x)))


@register_op("prelu_grad")
def prelu_grad(ctx):
    x = data_of(ctx.input("X"))
    a = data_of(ctx.input("Alpha"))
    d = data_of(ctx.input("Out@GRAD"))
    ctx.set_output("X@GRAD", torch.where(x > 0, d, a.reshape(()) * d))
    ctx.set_output("Alpha@GRAD", torch.where(
        x > 0, torch.zeros((), dtype=d.dtype, device=d.device),
        d * x).sum().reshape(a.shape))


# ---------------------------------------------------------------------------
# spp (spatial pyramid pooling)
# ---------------------------------------------------------------------------

def _spp_compute(x, height, ptype):
    """spp_op.h: level l pools into 2^l x 2^l bins (kernel = stride =
    ceil(size / bins), padding (kernel·bins - size + 1) / 2), each level
    flattened, all concatenated: [N, C·Σ4^l]."""
    n, _, h, w = x.shape
    outs = []
    for lvl in range(height):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pooled = pool2d_compute(x, (kh, kw), (kh, kw), (ph, pw), ptype,
                                False, False)
        outs.append(pooled.reshape(n, -1))
    return torch.cat(outs, dim=1)


@register_op("spp", grad=lambda op: [OpSpec(
    "spp_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def spp(ctx):
    ctx.set_output("Out", _spp_compute(
        data_of(ctx.input("X")), int(ctx.attr("pyramid_height")),
        ctx.attr("pooling_type", "max")))


@register_op("spp_grad")
def spp_grad(ctx):
    h = int(ctx.attr("pyramid_height"))
    ptype = ctx.attr("pooling_type", "max")
    dx, = vjp(lambda a: _spp_compute(a, h, ptype),
              (data_of(ctx.input("X")),), data_of(ctx.input("Out@GRAD")))
    ctx.set_output("X@GRAD", dx)


# ---------------------------------------------------------------------------
# max_pool2d_with_index, unpool
# ---------------------------------------------------------------------------

@register_op("max_pool2d_with_index")
def max_pool2d_with_index(ctx):
    """Max pooling that also gives each window's argmax as a flat index
    into its image's [H, W] plane (math/pooling.cc
    MaxPool2dWithIndexFunctor): what unpool consumes."""
    x = data_of(ctx.input("X"))
    ks = [int(k) for k in ctx.attr("ksize")]
    st = [int(s) for s in ctx.attr("strides", ks)]
    _, _, h, w = x.shape
    oh, ow = (h - ks[0]) // st[0] + 1, (w - ks[1]) // st[1] + 1
    patches = torch.stack([
        x[:, :, i:i + st[0] * oh:st[0], j:j + st[1] * ow:st[1]]
        for i in range(ks[0]) for j in range(ks[1])], dim=-1)
    arg = torch.argmax(patches, dim=-1)
    dev = x.device
    rows = torch.arange(oh, device=dev)[:, None] * st[0] + arg // ks[1]
    cols = torch.arange(ow, device=dev)[None, :] * st[1] + arg % ks[1]
    ctx.set_output("Out", patches.amax(dim=-1))
    ctx.set_output("Mask", (rows * w + cols).to(torch.int32))


@register_op("unpool", grad=lambda op: [OpSpec(
    "unpool_grad",
    {"Indices": op.input("Indices"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def unpool(ctx):
    """unpool_op.cc (max unpooling): each pooled value added at its argmax
    position of the [unpooled_h, unpooled_w] plane."""
    x = data_of(ctx.input("X"))
    idx = data_of(ctx.input("Indices")).long()
    uh, uw = (int(s) for s in ctx.attr("unpooled_size"))
    n, c = x.shape[:2]
    out = torch.zeros((n, c, uh * uw), dtype=x.dtype, device=x.device)
    out.scatter_add_(2, idx.reshape(n, c, -1), x.reshape(n, c, -1))
    ctx.set_output("Out", out.reshape(n, c, uh, uw))


@register_op("unpool_grad")
def unpool_grad(ctx):
    dy = data_of(ctx.input("Out@GRAD"))
    idx = data_of(ctx.input("Indices")).long()
    n, c = idx.shape[:2]
    ctx.set_output("X@GRAD", torch.gather(
        dy.reshape(n, c, -1), 2, idx.reshape(n, c, -1)).reshape(idx.shape))


# ---------------------------------------------------------------------------
# norm (cross-channel L2 normalization with a per-channel scale)
# ---------------------------------------------------------------------------

def _norm_compute(x, scale, eps):
    denom = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)
                       + eps)
    return x / denom * scale.reshape(1, -1, 1, 1)


@register_op("norm", infer_shape=same_shape("X", "Out"), grad=lambda op: [
    OpSpec("norm_grad",
           {"X": op.input("X"), "Scale": op.input("Scale"),
            "Out@GRAD": G(op.output("Out"))},
           {"X@GRAD": G(op.input("X")), "Scale@GRAD": G(op.input("Scale"))},
           dict(op.attrs))])
def norm(ctx):
    """norm_op.h: out[n, c, h, w] = scale[c] · x / sqrt(Σ_c x² + eps)."""
    ctx.set_output("Out", _norm_compute(
        data_of(ctx.input("X")), data_of(ctx.input("Scale")).reshape(-1),
        float(ctx.attr("epsilon", 1e-10))))


@register_op("norm_grad")
def norm_grad(ctx):
    scale = data_of(ctx.input("Scale"))
    eps = float(ctx.attr("epsilon", 1e-10))
    dx, ds = vjp(lambda a, s: _norm_compute(a, s, eps),
                 (data_of(ctx.input("X")), scale.reshape(-1)),
                 data_of(ctx.input("Out@GRAD")))
    ctx.set_output("X@GRAD", dx)
    ctx.set_output("Scale@GRAD", ds.reshape(scale.shape))


# ---------------------------------------------------------------------------
# margin_rank_loss, bilinear_tensor_product, is_empty
# ---------------------------------------------------------------------------

@register_op("margin_rank_loss", infer_shape=same_shape("X1", "Out"),
             grad=lambda op: [OpSpec(
                 "margin_rank_loss_grad",
                 {"Label": op.input("Label"), "X1": op.input("X1"),
                  "X2": op.input("X2"), "Out@GRAD": G(op.output("Out"))},
                 {"X1@GRAD": G(op.input("X1")),
                  "X2@GRAD": G(op.input("X2"))}, dict(op.attrs))])
def margin_rank_loss(ctx):
    """margin_rank_loss_op.h: max(0, -label·(x1 - x2) + margin)."""
    label = data_of(ctx.input("Label"))
    x1, x2 = data_of(ctx.input("X1")), data_of(ctx.input("X2"))
    ctx.set_output("Out", torch.clamp_min(
        -label * (x1 - x2) + float(ctx.attr("margin", 0.0)), 0.0))


@register_op("margin_rank_loss_grad")
def margin_rank_loss_grad(ctx):
    label = data_of(ctx.input("Label"))
    x1, x2 = data_of(ctx.input("X1")), data_of(ctx.input("X2"))
    d = data_of(ctx.input("Out@GRAD"))
    act = (-label * (x1 - x2) + float(ctx.attr("margin", 0.0))) > 0
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    ctx.set_output("X1@GRAD", torch.where(act, -label * d, zero))
    ctx.set_output("X2@GRAD", torch.where(act, label * d, zero))


def _btp_compute(x, y, w, bias=None):
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    return out if bias is None else out + bias.reshape(1, -1)


@register_op("bilinear_tensor_product", grad=lambda op: [OpSpec(
    "bilinear_tensor_product_grad",
    {"X": op.input("X"), "Y": op.input("Y"), "Weight": op.input("Weight"),
     **({"Bias": op.input("Bias")} if op.input("Bias") else {}),
     "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X")), "Y@GRAD": G(op.input("Y")),
     "Weight@GRAD": G(op.input("Weight")),
     **({"Bias@GRAD": G(op.input("Bias"))} if op.input("Bias") else {})})])
def bilinear_tensor_product(ctx):
    """bilinear_tensor_product_op.h: out[b, k] = x[b] W[k] y[b]ᵀ + bias[k]."""
    bias = data_of(ctx.input("Bias")) if ctx.has_input("Bias") else None
    ctx.set_output("Out", _btp_compute(
        data_of(ctx.input("X")), data_of(ctx.input("Y")),
        data_of(ctx.input("Weight")), bias))


@register_op("bilinear_tensor_product_grad")
def bilinear_tensor_product_grad(ctx):
    args = tuple(data_of(ctx.input(s)) for s in ("X", "Y", "Weight"))
    if ctx.has_input("Bias"):
        args += (data_of(ctx.input("Bias")),)
    grads = vjp(_btp_compute, args, data_of(ctx.input("Out@GRAD")))
    for slot, g in zip(("X@GRAD", "Y@GRAD", "Weight@GRAD", "Bias@GRAD"),
                       grads):
        ctx.set_output(slot, g)


@register_op("is_empty")
def is_empty(ctx):
    """is_empty_op.cc: a one-element bool, true iff X has no elements."""
    x = data_of(ctx.input("X"))
    ctx.set_output("Out", torch.tensor([x.numel() == 0], device=x.device))


# ---------------------------------------------------------------------------
# conv3d, pool3d
# ---------------------------------------------------------------------------

def _conv3d_args(attr):
    return (triple(attr("strides", [1, 1, 1])),
            triple(attr("paddings", [0, 0, 0])),
            triple(attr("dilations", [1, 1, 1])),
            int(attr("groups", 1) or 1))


def _conv3d_compute(x, w, strides, paddings, dilations, groups):
    """conv_op.cc's 3-D registration: NCDHW input, OIDHW filter, on
    bfloat16 operands under AMP (reference :546)."""
    x, w = cast_compute(x, w)
    return F.conv3d(x, w.to(x.dtype), stride=strides, padding=paddings,
                    dilation=dilations, groups=groups)


@register_op("conv3d", grad=lambda op: [OpSpec(
    "conv3d_grad",
    {"Input": op.input("Input"), "Filter": op.input("Filter"),
     "Output@GRAD": G(op.output("Output"))},
    {"Input@GRAD": G(op.input("Input")),
     "Filter@GRAD": G(op.input("Filter"))}, dict(op.attrs))])
def conv3d(ctx):
    ctx.set_output("Output", _conv3d_compute(
        data_of(ctx.input("Input")), data_of(ctx.input("Filter")),
        *_conv3d_args(ctx.attr)))


@register_op("conv3d_grad")
def conv3d_grad(ctx):
    args = _conv3d_args(ctx.attr)
    dx, dw = vjp(lambda a, b: _conv3d_compute(a, b, *args),
                 (data_of(ctx.input("Input")), data_of(ctx.input("Filter"))),
                 data_of(ctx.input("Output@GRAD")))
    ctx.set_output("Input@GRAD", dx)
    ctx.set_output("Filter@GRAD", dw)


def _pool3d_compute(x, ksize, strides, paddings, ptype, global_pooling):
    """pool_op.cc's 3-D form: max pads with -inf; avg divides by the window
    cells inside the volume where there is padding, by the window size
    where there is none."""
    d, h, w = x.shape[2:]
    if global_pooling:
        ksize, paddings = (d, h, w), (0, 0, 0)
    pads = (paddings[2], paddings[2], paddings[1], paddings[1],
            paddings[0], paddings[0])
    if ptype == "max":
        xp = F.pad(x, pads, value=float("-inf")) if any(paddings) else x
        return F.max_pool3d(xp, ksize, strides)
    xp = F.pad(x, pads) if any(paddings) else x
    sums = F.avg_pool3d(xp, ksize, strides, divisor_override=1)
    if any(paddings):
        ones = F.pad(torch.ones((1, 1, d, h, w), dtype=x.dtype,
                                device=x.device), pads)
        return sums / F.avg_pool3d(ones, ksize, strides, divisor_override=1)
    return sums / (ksize[0] * ksize[1] * ksize[2])


def _pool3d_args(attr):
    return (triple(attr("ksize", [2, 2, 2])),
            triple(attr("strides", [1, 1, 1])),
            triple(attr("paddings", [0, 0, 0])),
            attr("pooling_type", "max"),
            bool(attr("global_pooling", False)))


@register_op("pool3d", grad=lambda op: [OpSpec(
    "pool3d_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def pool3d(ctx):
    ctx.set_output("Out", _pool3d_compute(data_of(ctx.input("X")),
                                          *_pool3d_args(ctx.attr)))


@register_op("pool3d_grad")
def pool3d_grad(ctx):
    args = _pool3d_args(ctx.attr)
    dx, = vjp(lambda a: _pool3d_compute(a, *args),
              (data_of(ctx.input("X")),), data_of(ctx.input("Out@GRAD")))
    ctx.set_output("X@GRAD", dx)
