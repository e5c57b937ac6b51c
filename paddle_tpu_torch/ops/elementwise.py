"""Elementwise binary ops with the reference's axis-broadcast rule
(counterpart of paddle_tpu/ops/elementwise.py): elementwise_add, _sub,
_mul, _div, _max, _min and _pow and their grads, from one table of forward
and grad expressions as the reference's ``_FWD`` and ``_GRADS`` (:37-64);
LoD-transparent (reference :97, :108): a LoDArray operand keeps its
lengths in the result and in its gradient.

A SparseRows X times (or over) a one-element Y stays sparse (reference
:85-93): the gradient clip's scale factor applied to an ``is_sparse``
embedding's gradient scales the value block, so the table keeps its
sparse update."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, same_shape, OpSpec, G
from ..core.sparse import SparseRows, is_sparse
from .common import collapse_to, data_of, like


def _align(x, y, axis, x_is_lod=False, y_is_lod=False):
    """Reshape y so it broadcasts into x (reference elementwise.py:21): y's
    dims line up with x's starting at ``axis``; -1 aligns trailing dims. The
    reference's axis counts in a LoD tensor's flat [total_rows, *feat]
    layout, so against a padded LoDArray x (one more leading dim) and a
    dense y a positive axis moves one further. Operands of one rank
    broadcast as they are. The rule reads ranks and ``axis`` only, never a
    dim's size, so a traced batch dim stays symbolic. Returns (y reshaped,
    the axis used)."""
    if x.ndim == y.ndim:
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
    "elementwise_mul": lambda x, y: x * y,
    "elementwise_div": lambda x, y: x / y,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
    "elementwise_pow": torch.pow,
}

# (dx_fn, dy_fn), each of (x, y broadcast, out, dOut), before Y's broadcast
# is summed; the max/min masks are the reference's, ties to X for dX
_GRADS = {
    "elementwise_add": (lambda x, yb, o, d: d,
                        lambda x, yb, o, d: d),
    "elementwise_sub": (lambda x, yb, o, d: d,
                        lambda x, yb, o, d: -d),
    "elementwise_mul": (lambda x, yb, o, d: d * yb,
                        lambda x, yb, o, d: d * x),
    "elementwise_div": (lambda x, yb, o, d: d / yb,
                        lambda x, yb, o, d: -d * x / (yb * yb)),
    "elementwise_max": (lambda x, yb, o, d: d * (x >= yb),
                        lambda x, yb, o, d: d * (x < yb)),
    "elementwise_min": (lambda x, yb, o, d: d * (x <= yb),
                        lambda x, yb, o, d: d * (x > yb)),
    "elementwise_pow": (lambda x, yb, o, d: d * yb * torch.pow(x, yb - 1),
                        lambda x, yb, o, d: d * o * torch.log(
                            torch.where(x > 0, x, 1.0))),
}

# ops linear in X, which a SparseRows X passes through by its value block
_SPARSE_X = ("elementwise_mul", "elementwise_div")


def _register(op_type):
    fwd = _FWD[op_type]
    dx_fn, dy_fn = _GRADS[op_type]

    @register_op(op_type, infer_shape=same_shape("X", "Out"),
                 grad=_grad_maker)
    def forward(ctx):
        xv, yv = ctx.input("X"), ctx.input("Y")
        if is_sparse(xv) and op_type in _SPARSE_X \
                and data_of(yv).numel() == 1:
            ctx.set_output("Out", SparseRows(
                xv.rows, fwd(xv.values, data_of(yv).reshape(())), xv.nrows,
                xv.merged))
            return
        x, y = data_of(xv), data_of(yv)
        yb, _ = _align(x, y, ctx.attr("axis", -1), isinstance(xv, LoDArray),
                       isinstance(yv, LoDArray))
        ctx.set_output("Out", like(xv, fwd(x, yb)))

    @register_op(op_type + "_grad")
    def backward(ctx):
        """dX = dx_fn(...); dY = dy_fn(...) summed over the dims Y was
        broadcast along."""
        xv, yv = ctx.input("X"), ctx.input("Y")
        x, y = data_of(xv), data_of(yv)
        o, d = data_of(ctx.input("Out")), data_of(ctx.input("Out@GRAD"))
        yb, axis = _align(x, y, ctx.attr("axis", -1),
                          isinstance(xv, LoDArray), isinstance(yv, LoDArray))
        dy = dy_fn(x, yb, o, d)
        if y.shape != x.shape:
            dy = collapse_to(dy, y.shape, axis)
        ctx.set_output("X@GRAD", like(xv, dx_fn(x, yb, o, d).to(x.dtype)))
        ctx.set_output("Y@GRAD", like(yv, dy.to(y.dtype)))


for _t in _FWD:
    _register(_t)
