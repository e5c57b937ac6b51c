"""The embedding lookup (counterpart of paddle_tpu/ops/nn_ops.py):
``lookup_table`` (reference :47) and its dense gradient (reference :65).
The sparse (``is_sparse``) gradient waits for ``core/sparse.py``."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of, like


def _ids(v):
    """Int64 ids with a trailing dim of 1 dropped."""
    ids = data_of(v).long()
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    return ids


@register_op("lookup_table", grad=lambda op: [OpSpec(
    "lookup_table_grad",
    {"W": op.input("W"), "Ids": op.input("Ids"),
     "Out@GRAD": G(op.output("Out"))},
    {"W@GRAD": G(op.input("W"))}, dict(op.attrs))])
def lookup_table(ctx):
    w = ctx.input("W")
    ids_v = ctx.input("Ids")
    ids = _ids(ids_v)
    out = w[ids]
    padding_idx = ctx.attr("padding_idx", None)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    ctx.set_output("Out", like(ids_v, out))


@register_op("lookup_table_grad")
def lookup_table_grad(ctx):
    """W@GRAD as a dense [vocab, dim] scatter-add of Out@GRAD's rows; the
    padded positions of a LoD gradient are masked out first (reference
    :77-78). ``index_put_`` with ``accumulate=True`` sums duplicate ids in
    a fixed order on either device (a sort-based kernel on CUDA), so the
    gradient is the same on every run, where ``index_add_`` on CUDA sums
    them with atomics in an order that changes from run to run."""
    if ctx.attr("is_sparse", False):
        raise NotImplementedError(
            "lookup_table with is_sparse=True needs the SparseRows gradient "
            "(reference core/sparse.py), which is not ported yet")
    w = ctx.input("W")
    ids = _ids(ctx.input("Ids"))
    d_v = ctx.input("Out@GRAD")
    d = data_of(d_v)
    if isinstance(d_v, LoDArray):
        d = d * d_v.mask(d.dtype).reshape(d.shape[:2] + (1,) * (d.ndim - 2))
    dw = torch.zeros_like(w).index_put_(
        (ids.reshape(-1),), d.reshape(-1, w.shape[-1]).to(w.dtype),
        accumulate=True)
    ctx.set_output("W@GRAD", dw)
