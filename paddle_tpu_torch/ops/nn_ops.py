"""The embedding lookup (counterpart of paddle_tpu/ops/nn_ops.py):
``lookup_table`` (reference :47) and its gradient (reference :65), dense,
or with ``is_sparse`` a ``SparseRows`` (``core/sparse.py``) that the
optimizers' sparse branches consume without forming the [vocab, dim]
gradient."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from ..core.sparse import add_rows, sparse_rows_from_grad
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
    """W@GRAD from Out@GRAD's rows; the padded positions of a LoD gradient
    are masked out first (reference :77-78). Dense: a [vocab, dim]
    scatter-add (``core/sparse.py::add_rows``: duplicate ids summed in the
    ids' order on either device, the same on every run). With
    ``is_sparse``: a SparseRows of one entry per id, padded LoD positions
    sent to the sentinel row ``vocab`` (reference :82-90)."""
    w = ctx.input("W")
    ids = _ids(ctx.input("Ids"))
    d_v = ctx.input("Out@GRAD")
    d = data_of(d_v)
    if isinstance(d_v, LoDArray):
        d = d * d_v.mask(d.dtype).reshape(d.shape[:2] + (1,) * (d.ndim - 2))
    flat_ids = ids.reshape(-1)
    flat_d = d.reshape(-1, w.shape[-1]).to(w.dtype)
    if ctx.attr("is_sparse", False):
        if isinstance(d_v, LoDArray):
            valid = d_v.mask(torch.bool).reshape(-1)
            flat_ids = torch.where(valid, flat_ids,
                                   torch.full_like(flat_ids, w.shape[0]))
        ctx.set_output("W@GRAD",
                       sparse_rows_from_grad(flat_ids, flat_d, w.shape[0]))
        return
    ctx.set_output("W@GRAD", add_rows(torch.zeros_like(w), flat_ids, flat_d))
