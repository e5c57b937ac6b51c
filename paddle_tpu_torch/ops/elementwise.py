"""Elementwise binary ops with the reference's axis-broadcast rule
(counterpart of paddle_tpu/ops/elementwise.py): elementwise_add."""

from __future__ import annotations

from ..core.registry import register_op, same_shape


def _align(x, y, axis):
    """Reshape y so it broadcasts into x (reference elementwise.py:21): y's
    dims line up with x's starting at ``axis``; -1 aligns trailing dims."""
    if x.shape == y.shape:
        return y
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim)
    return y.reshape(new_shape)


@register_op("elementwise_add", infer_shape=same_shape("X", "Out"))
def elementwise_add(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    ctx.set_output("Out", x + _align(x, y, ctx.attr("axis", -1)))
