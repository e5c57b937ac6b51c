"""Dropout, the embedding lookup and the sharded-table routing ops
(counterpart of paddle_tpu/ops/nn_ops.py): ``dropout`` (reference :21)
and its gradient (reference :40); ``lookup_table`` (reference :47) and its
gradient (reference :65), dense, or with ``is_sparse`` a ``SparseRows``
(``core/sparse.py``) that the optimizers' sparse branches consume without
forming the [vocab, dim] gradient; ``split_ids`` (reference :95) and
``split_selected_rows`` (reference :119).

``split_ids``'s output sizes depend on the ids, so on a CUDA tensor it
waits for the device once a call (one read of the per-shard counts, not
one a shard); ``host_syncs()`` counts those waits."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, same_shape, OpSpec, G
from ..core.sparse import SparseRows, add_rows, sparse_rows_from_grad
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


# device waits made by the data-dependent ops here (split_ids)
_SYNCS = {"split_ids": 0}


def host_syncs():
    """Device waits made by ``split_ids`` on CUDA tensors so far."""
    return dict(_SYNCS)


@register_op("split_ids")
def split_ids(ctx):
    """Route ids to N shard outputs by id % N, each [k, 1] in the ids'
    order (reference split_ids_op.cc, the trainer-side prep for a sharded
    lookup table). A stable sort by shard and one read of the counts: on
    a CUDA tensor that is one device wait a call, counted in
    ``host_syncs()``."""
    ids = data_of(ctx.input("Ids")).reshape(-1, 1)
    n = len(ctx.op.output("Out"))
    shard = ids.reshape(-1) % n
    order = torch.sort(shard, stable=True)[1]
    # not bincount: on CUDA it reads the max id back first (a second wait)
    counts = torch.zeros(n, dtype=shard.dtype, device=shard.device) \
        .scatter_add_(0, shard, torch.ones_like(shard))
    if counts.device.type == "cuda":
        _SYNCS["split_ids"] += 1
    ctx.set_outputs("Out", list(torch.split(ids[order], counts.tolist())))


@register_op("split_selected_rows")
def split_selected_rows(ctx):
    """Split a SparseRows by row ranges (reference
    split_selected_rows_op.cc height_sections: rows [0,h0) to output 0
    as-is, [h0,h0+h1) to output 1 rebased, ...). Every output keeps the
    input's entry count; an entry outside an output's range becomes the
    sentinel row (that section's height) with zero values, which every
    consumer drops. Nothing waits on the device."""
    x = ctx.input("X")
    outs, start = [], 0
    for h in (int(s) for s in ctx.attr("height_sections")):
        in_range = (x.rows >= start) & (x.rows < start + h)
        rows = torch.where(in_range, x.rows - start,
                           torch.full_like(x.rows, h))
        mask = in_range.reshape((-1,) + (1,) * (x.values.ndim - 1))
        vals = torch.where(mask, x.values, torch.zeros_like(x.values))
        outs.append(SparseRows(rows, vals, h))
        start += h
    ctx.set_outputs("Out", outs)
