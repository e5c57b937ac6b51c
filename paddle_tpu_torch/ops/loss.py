"""Loss and classification ops (counterpart of paddle_tpu/ops/loss.py):
softmax over the last axis and its grad (reference :22-30), cross_entropy
on probabilities and its grad (reference :45, :62),
softmax_with_cross_entropy with its grad (reference :78, :100); and the
other losses, each with its grad: sigmoid_cross_entropy_with_logits
(:114), squared_l2_distance (:136), smooth_l1_loss (:164), log_loss
(:205), hinge_loss (:227), huber_loss (:248) and the hierarchical sigmoid
hsigmoid (:296). softmax, softmax_grad and cross_entropy(_grad) are
LoD-transparent."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.amp import upcast_f32
from ..core.registry import register_op, same_shape, OpSpec, G
from .common import data_of, like, vjp

# cross_entropy clamps a probability below this before its log
_CE_EPS = 1e-8


@register_op("softmax", infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "softmax_grad", {"Out": op.output("Out"),
                                  "Out@GRAD": G(op.output("Out"))},
                 {"X@GRAD": G(op.input("X"))})])
def softmax(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", like(x, torch.softmax(data_of(x), dim=-1)))


@register_op("softmax_grad")
def softmax_grad(ctx):
    """dX = Out·(dOut − Σ dOut·Out) over the last axis."""
    out = data_of(ctx.input("Out"))
    d = data_of(ctx.input("Out@GRAD"))
    dx = out * (d - torch.sum(d * out, dim=-1, keepdim=True))
    ctx.set_output("X@GRAD", like(ctx.input("Out@GRAD"), dx))


@register_op("cross_entropy", grad=lambda op: [OpSpec(
    "cross_entropy_grad",
    {"X": op.input("X"), "Label": op.input("Label"),
     "Y@GRAD": G(op.output("Y"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def cross_entropy(ctx):
    """−log p of the hard label (or −Σ label·log p with soft_label) per
    row, on probabilities clamped below at 1e-8."""
    xv = ctx.input("X")
    x = upcast_f32(data_of(xv))
    label = data_of(ctx.input("Label"))
    if ctx.attr("soft_label", False):
        y = -torch.sum(label * torch.log(x.clamp_min(_CE_EPS)), dim=-1,
                       keepdim=True)
    else:
        p = torch.gather(x, -1, _label_index(label, x.shape[:-1]))
        y = -torch.log(p.clamp_min(_CE_EPS))
    ctx.set_output("Y", like(xv, y))


@register_op("cross_entropy_grad")
def cross_entropy_grad(ctx):
    xv = ctx.input("X")
    x = data_of(xv)
    label = data_of(ctx.input("Label"))
    d = data_of(ctx.input("Y@GRAD"))
    if ctx.attr("soft_label", False):
        dx = -d * label / x.clamp_min(_CE_EPS)
    else:
        onehot = F.one_hot(label.reshape(x.shape[:-1]).long(), x.shape[-1]) \
            .to(x.dtype)
        dx = -d * onehot / x.clamp_min(_CE_EPS)
    ctx.set_output("X@GRAD", like(xv, dx))


def _label_index(label, lead_shape):
    """Hard int labels of shape [..., 1] as an int64 index [..., 1]."""
    return label.reshape(tuple(lead_shape) + (1,)).long()


@register_op("softmax_with_cross_entropy", grad=lambda op: [OpSpec(
    "softmax_with_cross_entropy_grad",
    {"Softmax": op.output("Softmax"), "Label": op.input("Label"),
     "Loss@GRAD": G(op.output("Loss"))},
    {"Logits@GRAD": G(op.input("Logits"))}, dict(op.attrs))])
def softmax_with_cross_entropy(ctx):
    """The stable log-sum-exp form, in float32 (bfloat16 logits are cast
    up first, the reference's stability island)."""
    logits = upcast_f32(ctx.input("Logits"))
    label = ctx.input("Label")
    log_probs = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * log_probs, dim=-1, keepdim=True)
    else:
        loss = -torch.gather(log_probs, -1,
                             _label_index(label, log_probs.shape[:-1]))
    ctx.set_output("Softmax", torch.exp(log_probs))
    ctx.set_output("Loss", loss)


@register_op("softmax_with_cross_entropy_grad")
def softmax_with_cross_entropy_grad(ctx):
    sm = ctx.input("Softmax")
    label = ctx.input("Label")
    d = ctx.input("Loss@GRAD")
    if ctx.attr("soft_label", False):
        dlogits = d * (sm - label)
    else:
        onehot = F.one_hot(label.reshape(-1).long(), sm.shape[-1]) \
            .to(sm.dtype).reshape(sm.shape)
        dlogits = d * (sm - onehot)
    ctx.set_output("Logits@GRAD", dlogits)


@register_op("sigmoid_cross_entropy_with_logits",
             infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "sigmoid_cross_entropy_with_logits_grad",
                 {"X": op.input("X"), "Label": op.input("Label"),
                  "Out@GRAD": G(op.output("Out"))},
                 {"X@GRAD": G(op.input("X"))})])
def sigmoid_cross_entropy_with_logits(ctx):
    """max(x, 0) − x·label + log(1 + exp(−|x|)), elementwise."""
    x = data_of(ctx.input("X"))
    label = data_of(ctx.input("Label"))
    ctx.set_output("Out", torch.clamp_min(x, 0) - x * label
                   + torch.log1p(torch.exp(-torch.abs(x))))


@register_op("sigmoid_cross_entropy_with_logits_grad")
def sigmoid_cross_entropy_with_logits_grad(ctx):
    x = data_of(ctx.input("X"))
    d = data_of(ctx.input("Out@GRAD"))
    ctx.set_output("X@GRAD",
                   d * (torch.sigmoid(x) - data_of(ctx.input("Label"))))


@register_op("squared_l2_distance", grad=lambda op: [OpSpec(
    "squared_l2_distance_grad",
    {"sub_result": op.output("sub_result"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X")), "Y@GRAD": G(op.input("Y"))})])
def squared_l2_distance(ctx):
    """Σ (x − y)² over the last axis, a one-row Y broadcast over X."""
    sub = data_of(ctx.input("X")) - data_of(ctx.input("Y"))
    ctx.set_output("sub_result", sub)
    ctx.set_output("Out", torch.sum(sub * sub, dim=-1, keepdim=True))


@register_op("squared_l2_distance_grad")
def squared_l2_distance_grad(ctx):
    """X@GRAD = 2·d·sub; Y@GRAD its negation, summed over the rows when
    the declared Y@GRAD has one row and sub has more (reference :157)."""
    g = 2.0 * data_of(ctx.input("Out@GRAD")) * data_of(
        ctx.input("sub_result"))
    ctx.set_output("X@GRAD", g)
    dy = -g
    ynames = ctx.op.output("Y@GRAD")
    if ynames and ctx.block.has_var(ynames[0]):
        yshape = ctx.block.var(ynames[0]).shape
        if yshape and yshape[0] == 1 and g.shape[0] != 1:
            dy = -torch.sum(g, dim=0, keepdim=True)
    ctx.set_output("Y@GRAD", dy)


def _smooth_l1_grad_maker(op):
    ins = {"Diff": op.output("Diff"), "Out@GRAD": G(op.output("Out"))}
    for slot in ("InsideWeight", "OutsideWeight"):
        if op.input(slot):
            ins[slot] = op.input(slot)
    return [OpSpec("smooth_l1_loss_grad", ins, {"X@GRAD": G(op.input("X"))},
                   dict(op.attrs))]


@register_op("smooth_l1_loss", grad=_smooth_l1_grad_maker)
def smooth_l1_loss(ctx):
    """Per-row Σ of 0.5·σ²·diff² where |diff| < 1/σ², else |diff| −
    0.5/σ²; InsideWeight gates the diff, OutsideWeight scales each
    element's loss before the row sum (smooth_l1_loss_op.h)."""
    x = data_of(ctx.input("X"))
    diff = x - data_of(ctx.input("Y"))
    sigma2 = ctx.attr("sigma", 1.0) ** 2
    if ctx.has_input("InsideWeight"):
        diff = diff * data_of(ctx.input("InsideWeight"))
    ad = torch.abs(diff)
    val = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                      ad - 0.5 / sigma2)
    if ctx.has_input("OutsideWeight"):
        val = val * data_of(ctx.input("OutsideWeight"))
    ctx.set_output("Diff", diff)
    ctx.set_output("Out", torch.sum(val, dim=tuple(range(1, x.ndim)))
                   .reshape(-1, 1))


@register_op("smooth_l1_loss_grad")
def smooth_l1_loss_grad(ctx):
    diff = data_of(ctx.input("Diff"))
    d = data_of(ctx.input("Out@GRAD")).reshape(
        (-1,) + (1,) * (diff.ndim - 1))
    sigma2 = ctx.attr("sigma", 1.0) ** 2
    g = torch.where(torch.abs(diff) < 1.0 / sigma2, sigma2 * diff,
                    torch.sign(diff))
    for slot in ("OutsideWeight", "InsideWeight"):
        if ctx.has_input(slot):
            g = g * data_of(ctx.input(slot))
    ctx.set_output("X@GRAD", d * g)


@register_op("log_loss", infer_shape=same_shape("Predicted", "Loss"),
             grad=lambda op: [OpSpec(
                 "log_loss_grad",
                 {"Predicted": op.input("Predicted"),
                  "Labels": op.input("Labels"),
                  "Loss@GRAD": G(op.output("Loss"))},
                 {"Predicted@GRAD": G(op.input("Predicted"))},
                 dict(op.attrs))])
def log_loss(ctx):
    """−y·log(p + ε) − (1 − y)·log(1 − p + ε)."""
    p = data_of(ctx.input("Predicted"))
    y = data_of(ctx.input("Labels"))
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Loss", -y * torch.log(p + eps)
                   - (1 - y) * torch.log(1 - p + eps))


@register_op("log_loss_grad")
def log_loss_grad(ctx):
    p = data_of(ctx.input("Predicted"))
    y = data_of(ctx.input("Labels"))
    d = data_of(ctx.input("Loss@GRAD"))
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Predicted@GRAD",
                   d * (-y / (p + eps) + (1 - y) / (1 - p + eps)))


@register_op("hinge_loss", infer_shape=same_shape("Logits", "Loss"),
             grad=lambda op: [OpSpec(
                 "hinge_loss_grad",
                 {"Logits": op.input("Logits"), "Labels": op.input("Labels"),
                  "Loss@GRAD": G(op.output("Loss"))},
                 {"Logits@GRAD": G(op.input("Logits"))})])
def hinge_loss(ctx):
    """max(1 − (2y − 1)·x, 0) with 0/1 labels y."""
    x = data_of(ctx.input("Logits"))
    y = data_of(ctx.input("Labels"))
    ctx.set_output("Loss", torch.clamp_min(1.0 - (2.0 * y - 1.0) * x, 0.0))


@register_op("hinge_loss_grad")
def hinge_loss_grad(ctx):
    x = data_of(ctx.input("Logits"))
    alt = 2.0 * data_of(ctx.input("Labels")) - 1.0
    d = data_of(ctx.input("Loss@GRAD"))
    ctx.set_output("Logits@GRAD", d * torch.where(
        1.0 - alt * x > 0, -alt, torch.zeros_like(alt)))


@register_op("huber_loss", grad=lambda op: [OpSpec(
    "huber_loss_grad",
    {"Residual": op.output("Residual"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X")), "Y@GRAD": G(op.input("Y"))},
    dict(op.attrs))])
def huber_loss(ctx):
    """With r = y − x: 0.5·r² where |r| ≤ δ, else δ·(|r| − 0.5·δ)."""
    r = data_of(ctx.input("Y")) - data_of(ctx.input("X"))
    delta = ctx.attr("delta", 1.0)
    ar = torch.abs(r)
    ctx.set_output("Residual", r)
    ctx.set_output("Out", torch.where(ar <= delta, 0.5 * r * r,
                                      delta * (ar - 0.5 * delta)))


@register_op("huber_loss_grad")
def huber_loss_grad(ctx):
    r = data_of(ctx.input("Residual"))
    d = data_of(ctx.input("Out@GRAD"))
    delta = ctx.attr("delta", 1.0)
    g = torch.where(torch.abs(r) <= delta, r, delta * torch.sign(r))
    ctx.set_output("X@GRAD", -d * g)
    ctx.set_output("Y@GRAD", d * g)


def _hsigmoid_compute(x, w, bias, label, num_classes):
    """Σ over the bits of the SimpleCode c = label + num_classes of
    softplus(z_b) − bit_b·z_b, z_b = x·w[node_b] (+ bias[node_b]), node_b
    = (c >> (b+1)) − 1 for the bits whose parent node exists (reference
    :279, MatrixBitCode.cpp)."""
    c = label.reshape(-1).long() + num_classes
    cost = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    xf = x.float()
    for b in range(int(num_classes - 1).bit_length()):
        parent = c >> (b + 1)
        valid = (parent >= 1).float()
        idx = torch.clamp_min(parent - 1, 0)
        bit = ((c >> b) & 1).float()
        z = torch.sum(xf * w[idx].float(), dim=-1)
        if bias is not None:
            z = z + bias.reshape(-1)[idx].float()
        cost = cost + valid * (F.softplus(z) - bit * z)
    return cost.reshape(-1, 1)


def _hsigmoid_grad_maker(op):
    has_bias = bool(op.input("Bias"))
    return [OpSpec(
        "hsigmoid_grad",
        {"X": op.input("X"), "W": op.input("W"), "Label": op.input("Label"),
         **({"Bias": op.input("Bias")} if has_bias else {}),
         "Out@GRAD": G(op.output("Out"))},
        {"X@GRAD": G(op.input("X")), "W@GRAD": G(op.input("W")),
         **({"Bias@GRAD": G(op.input("Bias"))} if has_bias else {})},
        dict(op.attrs))]


@register_op("hsigmoid", grad=_hsigmoid_grad_maker)
def hsigmoid(ctx):
    """The hierarchical sigmoid cost over the complete binary tree of
    ``num_classes`` leaves (HierarchicalSigmoidLayer)."""
    bias = data_of(ctx.input("Bias")) if ctx.has_input("Bias") else None
    ctx.set_output("Out", _hsigmoid_compute(
        data_of(ctx.input("X")), data_of(ctx.input("W")), bias,
        data_of(ctx.input("Label")), int(ctx.attr("num_classes"))))


@register_op("hsigmoid_grad")
def hsigmoid_grad(ctx):
    """Through autograd of the same bit loop (the reference's jax.vjp)."""
    label = data_of(ctx.input("Label"))
    n = int(ctx.attr("num_classes"))
    has_bias = ctx.has_input("Bias")
    primals = [data_of(ctx.input("X")), data_of(ctx.input("W"))] + (
        [data_of(ctx.input("Bias"))] if has_bias else [])

    def f(x, w, *b):
        return _hsigmoid_compute(x, w, b[0] if b else None, label, n)

    grads = vjp(f, primals, data_of(ctx.input("Out@GRAD")).reshape(-1, 1))
    ctx.set_output("X@GRAD", grads[0])
    ctx.set_output("W@GRAD", grads[1])
    if has_bias:
        ctx.set_output("Bias@GRAD", grads[2])
