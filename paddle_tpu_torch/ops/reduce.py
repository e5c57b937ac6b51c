"""Reduction ops (counterpart of paddle_tpu/ops/reduce.py): mean over all
elements (reference :16) and its grad (reference :35)."""

from __future__ import annotations

import torch

from ..core.registry import register_op, OpSpec, G


@register_op("mean", grad=lambda op: [OpSpec(
    "mean_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))})])
def mean(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.mean(x).reshape(()).to(x.dtype))


@register_op("mean_grad")
def mean_grad(ctx):
    x = ctx.input("X")
    d = ctx.input("Out@GRAD").reshape(())
    ctx.set_output("X@GRAD", (d / x.numel()).expand(x.shape)
                   .to(x.dtype).contiguous())
