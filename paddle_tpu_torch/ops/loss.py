"""Classification ops (counterpart of paddle_tpu/ops/loss.py): softmax
over the last axis and its grad (reference :22-30), cross_entropy on
probabilities and its grad (reference :45, :62), and
softmax_with_cross_entropy with its grad (reference :78, :100). softmax,
softmax_grad and cross_entropy(_grad) are LoD-transparent."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op, same_shape, OpSpec, G
from .common import data_of, like

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


def _probs(xv):
    x = data_of(xv)
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


@register_op("cross_entropy", grad=lambda op: [OpSpec(
    "cross_entropy_grad",
    {"X": op.input("X"), "Label": op.input("Label"),
     "Y@GRAD": G(op.output("Y"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def cross_entropy(ctx):
    """−log p of the hard label (or −Σ label·log p with soft_label) per
    row, on probabilities clamped below at 1e-8."""
    xv = ctx.input("X")
    x = _probs(xv)
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
    logits = ctx.input("Logits")
    if logits.dtype in (torch.bfloat16, torch.float16):
        logits = logits.float()
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
