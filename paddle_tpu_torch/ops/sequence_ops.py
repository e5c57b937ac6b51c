"""Sequence (LoD) ops over the padded LoDArray (counterpart of
paddle_tpu/ops/sequence_ops.py): ``sequence_pool`` with pooltype LAST
(reference :74, :163) and its grad (reference :183). The other pool types
and sequence ops wait for a later slice."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of


def _seq(v):
    if not isinstance(v, LoDArray):
        raise TypeError(f"sequence op expects a LoDArray input, got "
                        f"{type(v).__name__}")
    return v


def _last_index(x):
    """[b] int64 index of each row's last valid step (0 for an empty row,
    as the reference's ``max(lens - 1, 0)``)."""
    return (x.lens.long() - 1).clamp_min(0)


def _pooltype(ctx):
    pooltype = ctx.attr("pooltype", "AVERAGE")
    if pooltype != "LAST" or int(ctx.attr("stride", 0) or 0) > 0:
        raise NotImplementedError(
            f"sequence_pool pooltype={pooltype!r} (stride "
            f"{ctx.attr('stride', 0)}) is not ported yet; only LAST is")
    return pooltype


def _sp_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        out.shape = tuple(x.shape[:1]) + tuple(x.shape[2:]) \
            if len(x.shape) > 2 else x.shape
    out.dtype = x.dtype
    out.lod_level = 0


@register_op("sequence_pool", infer_shape=_sp_infer, grad=lambda op: [OpSpec(
    "sequence_pool_grad",
    {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def sequence_pool(ctx):
    """[b, L, *feat] LoDArray -> dense [b, *feat]: each row's last valid
    step."""
    x = _seq(ctx.input("X"))
    _pooltype(ctx)
    rows = torch.arange(x.data.shape[0], device=x.data.device)
    ctx.set_output("Out", x.data[rows, _last_index(x)])


@register_op("sequence_pool_grad")
def sequence_pool_grad(ctx):
    """The output grad scattered back to each row's last valid step; zeros
    elsewhere (the reference's vjp of the gather)."""
    x = _seq(ctx.input("X"))
    _pooltype(ctx)
    dy = data_of(ctx.input("Out@GRAD"))
    dx = torch.zeros_like(x.data)
    rows = torch.arange(x.data.shape[0], device=x.data.device)
    dx[rows, _last_index(x)] = dy.to(dx.dtype)
    ctx.set_output("X@GRAD", LoDArray(dx, x.lens))
