"""maxout, im2sequence, rank_loss and nce, each with its grad (counterpart
of paddle_tpu/ops/misc_ops.py :95, :275, :308 and :430).

Plain PyTorch, as the reference's are plain jnp. Each grad is the
vector-Jacobian product of the forward's math through autograd
(``common.vjp``), as the reference's are ``jax.vjp`` of theirs, except
rank_loss_grad, which is the reference's closed form.

nce draws its negatives from the executor's generator, or takes
``custom_neg_classes`` (the reference's test hook, and the way two
packages give the same samples). The drawn samples are the op's
SampleLabels output, which nce_grad reads, so the cost and the gradient
describe the same sampled loss.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, infer_output, same_shape, OpSpec, G
from .common import data_of, vjp


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
