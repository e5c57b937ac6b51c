"""Activation ops (counterpart of paddle_tpu/ops/activation.py): relu
(reference :60) and its grad, which reads Out as the reference's does."""

from __future__ import annotations

import torch

from ..core.registry import register_op, same_shape, OpSpec, G


@register_op("relu", infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "relu_grad", {"Out": op.output("Out"),
                               "Out@GRAD": G(op.output("Out"))},
                 {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def relu(ctx):
    ctx.set_output("Out", torch.clamp_min(ctx.input("X"), 0))


@register_op("relu_grad")
def relu_grad(ctx):
    d = ctx.input("Out@GRAD")
    ctx.set_output("X@GRAD", d * (ctx.input("Out") > 0))
