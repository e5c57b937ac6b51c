"""Matrix-multiply ops (counterpart of paddle_tpu/ops/matmul.py): ``mul``
with the reference's flatten-to-2D semantics (reference :40) and its grad
(reference :58), accumulated in float32 like the reference's
``preferred_element_type``. Both are LoD-transparent (reference :46, :65):
a LoDArray X keeps its lengths in Out and X@GRAD.

Under AMP (reference :51, :67) the operands are cast to bfloat16 and the
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
