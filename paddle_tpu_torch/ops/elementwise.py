"""Elementwise binary ops with the reference's axis-broadcast rule
(counterpart of paddle_tpu/ops/elementwise.py): elementwise_add and its
grad (reference :69, :100)."""

from __future__ import annotations

from ..core.registry import register_op, same_shape, OpSpec, G
from .common import collapse_to


def _align(x, y, axis):
    """Reshape y so it broadcasts into x (reference elementwise.py:21): y's
    dims line up with x's starting at ``axis``; -1 aligns trailing dims.
    Returns (y reshaped, the axis used)."""
    if x.shape == y.shape:
        return y, 0
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim)
    return y.reshape(new_shape), axis


def _grad_maker(op):
    return [OpSpec(op.type + "_grad",
                   inputs={"X": op.input("X"), "Y": op.input("Y"),
                           "Out": op.output("Out"),
                           "Out@GRAD": G(op.output("Out"))},
                   outputs={"X@GRAD": G(op.input("X")),
                            "Y@GRAD": G(op.input("Y"))},
                   attrs=dict(op.attrs))]


@register_op("elementwise_add", infer_shape=same_shape("X", "Out"),
             grad=_grad_maker)
def elementwise_add(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    ctx.set_output("Out", x + _align(x, y, ctx.attr("axis", -1))[0])


@register_op("elementwise_add_grad")
def elementwise_add_grad(ctx):
    """dX = dOut; dY = dOut summed over the dims Y was broadcast along."""
    x, y = ctx.input("X"), ctx.input("Y")
    d = ctx.input("Out@GRAD")
    _, axis = _align(x, y, ctx.attr("axis", -1))
    dy = collapse_to(d, y.shape, axis) if y.shape != x.shape else d
    ctx.set_output("X@GRAD", d.to(x.dtype))
    ctx.set_output("Y@GRAD", dy.to(y.dtype))
