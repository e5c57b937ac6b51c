"""Reduction ops (counterpart of paddle_tpu/ops/reduce.py): mean over all
elements (reference :16) and its grad (reference :35). Over a LoDArray the
mean is over the valid (unpadded) elements, as upstream's mean over a
ragged tensor's real rows. ``reduce_sum|mean|max|min|prod`` and their
grads (``_reg_reduce``, reference :60) over ``dim`` (an int or a list),
with ``keep_dim`` and ``reduce_all``; a LoDArray reduces its padded data,
as the reference's does. The max/min grad gives the whole gradient to
every element equal to the result (reference :92-94), ties included: not
``torch.amax``'s even split."""

from __future__ import annotations

import math

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of


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


def _axes(ctx, x):
    if ctx.attr("reduce_all", False):
        return tuple(range(x.ndim))
    dim = ctx.attr("dim", 0)
    if isinstance(dim, (list, tuple)):
        return tuple(d % x.ndim for d in dim)
    return (dim % x.ndim,)


def _prod(x, dim, keepdim):
    for a in sorted(dim, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def _reg_reduce(name, fn, grad_fn):
    def maker(op):
        return [OpSpec(name + "_grad",
                       {"X": op.input("X"), "Out": op.output("Out"),
                        "Out@GRAD": G(op.output("Out"))},
                       {"X@GRAD": G(op.input("X"))}, dict(op.attrs))]

    @register_op(name, grad=maker)
    def forward(ctx):
        x = data_of(ctx.input("X"))
        out = fn(x, dim=_axes(ctx, x), keepdim=ctx.attr("keep_dim", False))
        ctx.set_output("Out", out.to(x.dtype))

    @register_op(name + "_grad")
    def backward(ctx):
        x = data_of(ctx.input("X"))
        out = data_of(ctx.input("Out"))
        d = data_of(ctx.input("Out@GRAD"))
        axes = _axes(ctx, x)
        if not ctx.attr("keep_dim", False):
            shape = [1 if i in axes else s for i, s in enumerate(x.shape)]
            d, out = d.reshape(shape), out.reshape(shape)
        ctx.set_output("X@GRAD", grad_fn(x, out.expand(x.shape),
                                         d.expand(x.shape), axes))


_reg_reduce("reduce_sum", torch.sum, lambda x, o, d, ax: d.contiguous())
_reg_reduce("reduce_mean", torch.mean,
            lambda x, o, d, ax: d / math.prod(x.shape[a] for a in ax))
_reg_reduce("reduce_max", torch.amax, lambda x, o, d, ax: d * (x == o))
_reg_reduce("reduce_min", torch.amin, lambda x, o, d, ax: d * (x == o))
_reg_reduce("reduce_prod", _prod, lambda x, o, d, ax: d * o / x)
