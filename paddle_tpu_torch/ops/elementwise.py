"""Elementwise binary ops with the reference's axis-broadcast rule
(counterpart of paddle_tpu/ops/elementwise.py): elementwise_add and
elementwise_sub and their grads, from one table of forward and grad
expressions as the reference's ``_FWD`` and ``_GRADS`` (:37-64);
LoD-transparent (reference :97, :108): a LoDArray operand keeps its
lengths in the result and in its gradient."""

from __future__ import annotations

from ..core.lod import LoDArray
from ..core.registry import register_op, same_shape, OpSpec, G
from .common import collapse_to, data_of, like


def _align(x, y, axis, x_is_lod=False, y_is_lod=False):
    """Reshape y so it broadcasts into x (reference elementwise.py:21): y's
    dims line up with x's starting at ``axis``; -1 aligns trailing dims. The
    reference's axis counts in a LoD tensor's flat [total_rows, *feat]
    layout, so against a padded LoDArray x (one more leading dim) and a
    dense y a positive axis moves one further. Returns (y reshaped, the
    axis used)."""
    if x.shape == y.shape:
        return y, 0
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    elif x_is_lod and not y_is_lod and axis >= 1:
        axis += 1
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


_FWD = {
    "elementwise_add": lambda x, y: x + y,
    "elementwise_sub": lambda x, y: x - y,
}

# d(Out)/dX and d(Out)/dY applied to dOut, before Y's broadcast is summed
_GRADS = {
    "elementwise_add": (lambda d: d, lambda d: d),
    "elementwise_sub": (lambda d: d, lambda d: -d),
}


def _register(op_type):
    fwd = _FWD[op_type]
    dx_fn, dy_fn = _GRADS[op_type]

    @register_op(op_type, infer_shape=same_shape("X", "Out"),
                 grad=_grad_maker)
    def forward(ctx):
        xv, yv = ctx.input("X"), ctx.input("Y")
        x, y = data_of(xv), data_of(yv)
        yb, _ = _align(x, y, ctx.attr("axis", -1), isinstance(xv, LoDArray),
                       isinstance(yv, LoDArray))
        ctx.set_output("Out", like(xv, fwd(x, yb)))

    @register_op(op_type + "_grad")
    def backward(ctx):
        """dX = dx_fn(dOut); dY = dy_fn(dOut) summed over the dims Y was
        broadcast along."""
        xv, yv = ctx.input("X"), ctx.input("Y")
        x, y = data_of(xv), data_of(yv)
        d = data_of(ctx.input("Out@GRAD"))
        _, axis = _align(x, y, ctx.attr("axis", -1),
                         isinstance(xv, LoDArray), isinstance(yv, LoDArray))
        dy = dy_fn(d)
        if y.shape != x.shape:
            dy = collapse_to(dy, y.shape, axis)
        ctx.set_output("X@GRAD", like(xv, dx_fn(d).to(x.dtype)))
        ctx.set_output("Y@GRAD", like(yv, dy.to(y.dtype)))


for _t in _FWD:
    _register(_t)
