"""Matrix-multiply ops (counterpart of paddle_tpu/ops/matmul.py): ``mul``
with the reference's flatten-to-2D semantics (reference :40) and its grad
(reference :58), accumulated in float32 like the reference's
``preferred_element_type``. Both are LoD-transparent (reference :46, :65):
a LoDArray X keeps its lengths in Out and X@GRAD. The batched ``matmul``
with its transpose flags (reference :126) and its grad (reference :137),
whose batch-broadcast gradients are summed back to each operand's shape,
and the row-wise ``cos_sim`` (reference :82) and its grad.

Under AMP (reference :51, :67; ``matmul`` at :129 and :140) the operands are cast to bfloat16 and the
GEMM is a bfloat16 GEMM: float32 accumulation (``core/amp.py`` keeps
cuBLAS from reducing in bfloat16), the output rounded once to bfloat16, as
the reference's ``.astype(x.dtype)`` of its float32 product. Out, X@GRAD and
Y@GRAD then come back in bfloat16, the cast operands' dtype. Otherwise the
operands are upcast to float32 and each output is cast to its input's
dtype."""

from __future__ import annotations

import math

import torch

from ..core.amp import amp_enabled, cast_compute
from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of, like


def _flat2d(x, num_col_dims):
    return x.reshape(math.prod(x.shape[:num_col_dims]),
                     math.prod(x.shape[num_col_dims:]))


def _mul_grad_maker(op):
    return [OpSpec("mul_grad",
                   {"X": op.input("X"), "Y": op.input("Y"),
                    "Out@GRAD": G(op.output("Out"))},
                   {"X@GRAD": G(op.input("X")), "Y@GRAD": G(op.input("Y"))},
                   dict(op.attrs))]


def _gemm_operands(*ts):
    """The operands as the GEMM takes them: as ``cast_compute`` left them
    (bfloat16) under AMP, float32 otherwise."""
    return ts if amp_enabled() else tuple(t.float() for t in ts)


def _x_num_col_dims(ctx, xv):
    """The reference's split point, one further for a LoDArray: its padded
    [b, L, *feat] layout has one more leading dim than the flat
    [total_rows, *feat] form the attribute counts in."""
    xnc = ctx.attr("x_num_col_dims", 1)
    return xnc + 1 if isinstance(xv, LoDArray) else xnc


@register_op("mul", grad=_mul_grad_maker)
def mul(ctx):
    xv = ctx.input("X")
    x, y = cast_compute(data_of(xv), ctx.input("Y"))
    xnc = _x_num_col_dims(ctx, xv)
    ync = ctx.attr("y_num_col_dims", 1)
    out = torch.matmul(*_gemm_operands(_flat2d(x, xnc), _flat2d(y, ync)))
    ctx.set_output("Out", like(xv, out.to(x.dtype).reshape(
        tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))))


@register_op("mul_grad")
def mul_grad(ctx):
    xv = ctx.input("X")
    x, y, d = cast_compute(data_of(xv), ctx.input("Y"),
                           data_of(ctx.input("Out@GRAD")))
    x2, y2 = _gemm_operands(_flat2d(x, _x_num_col_dims(ctx, xv)),
                            _flat2d(y, ctx.attr("y_num_col_dims", 1)))
    d2, = _gemm_operands(d.reshape(x2.shape[0], y2.shape[1]))
    ctx.set_output("X@GRAD", like(xv, torch.matmul(d2, y2.T)
                                  .reshape(x.shape).to(x.dtype)))
    ctx.set_output("Y@GRAD", torch.matmul(x2.T, d2).reshape(y.shape)
                   .to(y.dtype))


def _cos_norms(x, y):
    return (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)),
            torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True)))


def _cos_sim_grad_maker(op):
    ins = {"X": op.input("X"), "Y": op.input("Y"), "Out": op.output("Out"),
           "Out@GRAD": G(op.output("Out"))}
    for slot in ("XNorm", "YNorm"):
        if op.output(slot):
            ins[slot] = op.output(slot)
    return [OpSpec("cos_sim_grad", ins,
                   {"X@GRAD": G(op.input("X")), "Y@GRAD": G(op.input("Y"))})]


@register_op("cos_sim", grad=_cos_sim_grad_maker)
def cos_sim(ctx):
    """Out = x·y / (‖x‖‖y‖ + 1e-12) per row (cos_sim_op.cc); a one-row Y
    broadcasts over X's rows. XNorm and YNorm, where the op names them,
    keep the norms for the grad."""
    x, y = data_of(ctx.input("X")), data_of(ctx.input("Y"))
    xn, yn = _cos_norms(x, y)
    ctx.set_output("Out", torch.sum(x * y, dim=-1, keepdim=True)
                   / (xn * yn + 1e-12))
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)


@register_op("cos_sim_grad")
def cos_sim_grad(ctx):
    """d/dx = d·(y − out·‖y‖·x/‖x‖) / (‖x‖‖y‖ + 1e-12), and the same for y
    with the roles swapped; a broadcast Y row sums its rows' gradients.
    Out and the norms are recomputed where the op does not name them."""
    x, y = data_of(ctx.input("X")), data_of(ctx.input("Y"))
    d = data_of(ctx.input("Out@GRAD"))
    if ctx.has_input("XNorm"):
        xn, yn = ctx.input("XNorm"), ctx.input("YNorm")
    else:
        xn, yn = _cos_norms(x, y)
    den = xn * yn + 1e-12
    out = data_of(ctx.input("Out")) if ctx.has_input("Out") \
        else torch.sum(x * y, dim=-1, keepdim=True) / den
    dx = d * (y - out * yn * x / xn) / den
    dy = d * (x - out * xn * y / yn) / den
    if dy.shape != y.shape:
        dy = torch.sum(dy, dim=0, keepdim=True)
    ctx.set_output("X@GRAD", dx)
    ctx.set_output("Y@GRAD", dy)


def _matmul_grad_maker(op):
    return [OpSpec("matmul_grad",
                   {"X": op.input("X"), "Y": op.input("Y"),
                    "Out@GRAD": G(op.output("Out"))},
                   {"X@GRAD": G(op.input("X")), "Y@GRAD": G(op.input("Y"))},
                   dict(op.attrs))]


def _mm(x, y, tx, ty):
    """torch.matmul with a 1-D X as a row and a 1-D Y as a column, each
    transposed on its flag, the operands as the GEMM takes them."""
    if x.ndim == 1:
        x = x[None, :]
    if y.ndim == 1:
        y = y[:, None]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    return torch.matmul(*_gemm_operands(x, y))


@register_op("matmul", grad=_matmul_grad_maker)
def matmul(ctx):
    """Batched X @ Y with the reference's broadcast of batch dims; two
    1-D operands give a scalar. LoD-transparent in X."""
    xv = ctx.input("X")
    x, y = cast_compute(data_of(xv), data_of(ctx.input("Y")))
    out = _mm(x, y, ctx.attr("transpose_X", False),
              ctx.attr("transpose_Y", False))
    if x.ndim == 1 and y.ndim == 1:
        out = out.reshape(())
    ctx.set_output("Out", like(xv, out.to(x.dtype)))


def _fit(g, ref):
    """A gradient summed over its leading broadcast dims down to ``ref``'s
    rank, in ``ref``'s shape and dtype (reference :158). One of ``ref``'s
    size is only reshaped: the [K, 1] grad of a 1-D Y, which the
    reference's sum over axis 0 would collapse to [1] (its vector-vector
    grad raises there)."""
    if g.numel() != ref.numel():
        while g.ndim > ref.ndim:
            g = torch.sum(g, dim=0)
    return g.reshape(ref.shape).to(ref.dtype)


@register_op("matmul_grad")
def matmul_grad(ctx):
    xv = ctx.input("X")
    x, y, d = cast_compute(data_of(xv), data_of(ctx.input("Y")),
                           data_of(ctx.input("Out@GRAD")))
    tx, ty = ctx.attr("transpose_X", False), ctx.attr("transpose_Y", False)
    if x.ndim == 1 and y.ndim == 1:
        d = d.reshape(1, 1)
    if not tx and not ty:
        dx, dy = _mm(d, y, False, True), _mm(x, d, True, False)
    elif tx and not ty:
        dx, dy = _mm(y, d, False, True), _mm(x, d, False, False)
    elif not tx and ty:
        dx, dy = _mm(d, y, False, False), _mm(d, x, True, False)
    else:
        dx, dy = _mm(y, d, True, True), _mm(d, x, True, True)
    ctx.set_output("X@GRAD", like(xv, _fit(dx, x)))
    ctx.set_output("Y@GRAD", _fit(dy, y))
