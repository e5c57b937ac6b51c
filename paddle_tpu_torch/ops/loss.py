"""Classification ops (counterpart of paddle_tpu/ops/loss.py): softmax
over the last axis (reference :22) and softmax_with_cross_entropy with its
grad (reference :78, :100)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op, same_shape, OpSpec, G


@register_op("softmax", infer_shape=same_shape("X", "Out"))
def softmax(ctx):
    ctx.set_output("Out", torch.softmax(ctx.input("X"), dim=-1))


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
