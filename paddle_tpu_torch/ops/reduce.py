"""Reduction ops (counterpart of paddle_tpu/ops/reduce.py): mean over all
elements (reference :16) and its grad (reference :35). Over a LoDArray the
mean is over the valid (unpadded) elements, as upstream's mean over a
ragged tensor's real rows."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G


def _lod_mask_count(xv):
    """(the [b, L, 1, ...] validity mask, the count of valid elements)."""
    feat = 1
    for d in xv.data.shape[2:]:
        feat *= int(d)
    m = xv.mask(xv.data.dtype).reshape(
        tuple(xv.data.shape[:2]) + (1,) * (xv.data.ndim - 2))
    return m, xv.lens.sum().to(xv.data.dtype) * feat


@register_op("mean", grad=lambda op: [OpSpec(
    "mean_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))})])
def mean(ctx):
    x = ctx.input("X")
    if isinstance(x, LoDArray):
        m, count = _lod_mask_count(x)
        ctx.set_output("Out", (torch.sum(x.data * m) / count).reshape(()))
        return
    ctx.set_output("Out", torch.mean(x).reshape(()).to(x.dtype))


@register_op("mean_grad")
def mean_grad(ctx):
    x = ctx.input("X")
    d = ctx.input("Out@GRAD").reshape(())
    if isinstance(x, LoDArray):
        m, count = _lod_mask_count(x)
        ctx.set_output("X@GRAD", x.with_data(
            (m * (d / count)).expand(x.data.shape).contiguous()))
        return
    ctx.set_output("X@GRAD", (d / x.numel()).expand(x.shape)
                   .to(x.dtype).contiguous())
