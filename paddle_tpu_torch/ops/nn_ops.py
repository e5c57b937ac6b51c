"""Dropout and the embedding lookup (counterpart of
paddle_tpu/ops/nn_ops.py): ``dropout`` (reference :21) and its gradient
(reference :40); ``lookup_table`` (reference :47) and its gradient
(reference :65), dense, or with ``is_sparse`` a ``SparseRows``
(``core/sparse.py``) that the optimizers' sparse branches consume without
forming the [vocab, dim] gradient."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, same_shape, OpSpec, G
from ..core.sparse import add_rows, sparse_rows_from_grad
from .common import data_of, like


@register_op("dropout", infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "dropout_grad",
                 {"Mask": op.output("Mask"), "Out@GRAD": G(op.output("Out"))},
                 {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def dropout(ctx):
    """Paddle's 2018 dropout (dropout_op.h), not the inverted one of
    ``torch.nn.functional.dropout``: training gives Out = X * Mask with
    Mask ~ Bernoulli(1 - dropout_prob) and no 1/(1-p) upscale; ``is_test``
    gives X * (1 - p) and an all-ones Mask. The mask is a uniform draw
    from the executor's generator kept where it is below 1 - p (the
    reference's ``jax.random.bernoulli`` rule, not its bits)."""
    x = ctx.input("X")
    xd = data_of(x)
    prob = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False):
        ctx.set_output("Out", like(x, xd * (1.0 - prob)))
        ctx.set_output("Mask", like(x, torch.ones_like(xd)))
        return
    u = torch.rand(xd.shape, generator=ctx.generator(), dtype=torch.float32,
                   device=xd.device)
    mask = (u < 1.0 - prob).to(xd.dtype)
    ctx.set_output("Out", like(x, xd * mask))
    ctx.set_output("Mask", like(x, mask))


@register_op("dropout_grad")
def dropout_grad(ctx):
    d = ctx.input("Out@GRAD")
    ctx.set_output("X@GRAD", like(d, data_of(d) * data_of(ctx.input("Mask"))))


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
