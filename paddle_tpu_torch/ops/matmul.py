"""Matrix-multiply ops (counterpart of paddle_tpu/ops/matmul.py): ``mul``
with the reference's flatten-to-2D semantics (reference :40), accumulated
in float32 like the reference's ``preferred_element_type``."""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op


def _flat2d(x, num_col_dims):
    return x.reshape(math.prod(x.shape[:num_col_dims]),
                     math.prod(x.shape[num_col_dims:]))


@register_op("mul")
def mul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xnc = ctx.attr("x_num_col_dims", 1)
    ync = ctx.attr("y_num_col_dims", 1)
    out = torch.matmul(_flat2d(x, xnc).float(), _flat2d(y, ync).float())
    ctx.set_output("Out", out.to(x.dtype).reshape(
        tuple(x.shape[:xnc]) + tuple(y.shape[ync:])))
