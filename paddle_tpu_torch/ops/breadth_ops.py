"""pad and crop with their grads, and positive_negative_pair (counterpart
of paddle_tpu/ops/breadth_ops.py :95, :130 and :445). Plain PyTorch."""

from __future__ import annotations

import torch

from ..core.registry import register_op, infer_output, OpSpec, G
from .common import data_of


# ---------------------------------------------------------------------------
# pad
# ---------------------------------------------------------------------------

def _pad_pairs(ctx_attr, ndim):
    flat = [int(p) for p in ctx_attr("paddings")]
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(ndim)]


def _pad_infer(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        return
    flat = op.attrs.get("paddings", [])
    shape = tuple(int(s + flat[2 * i] + flat[2 * i + 1])
                  for i, s in enumerate(x.shape))
    infer_output(op, block, "Out", shape, dtype=x.dtype)


@register_op("pad", infer_shape=_pad_infer, grad=lambda op: [OpSpec(
    "pad_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def pad(ctx):
    """pad_op.cc: each dim widened by its (before, after) pair, the new
    cells ``pad_value``."""
    x = data_of(ctx.input("X"))
    pairs = _pad_pairs(ctx.attr, x.ndim)
    flat = [p for pair in reversed(pairs) for p in pair]
    ctx.set_output("Out", torch.nn.functional.pad(
        x, flat, value=float(ctx.attr("pad_value", 0.0))))


@register_op("pad_grad")
def pad_grad(ctx):
    x = data_of(ctx.input("X"))
    dy = data_of(ctx.input("Out@GRAD"))
    pairs = _pad_pairs(ctx.attr, x.ndim)
    sl = tuple(slice(b, b + s) for (b, _), s in zip(pairs, x.shape))
    ctx.set_output("X@GRAD", dy[sl])


# ---------------------------------------------------------------------------
# crop
# ---------------------------------------------------------------------------

def _crop_infer(op, block):
    if op.attrs.get("shape"):
        x = block.var(op.input("X")[0])
        infer_output(op, block, "Out", tuple(op.attrs["shape"]),
                     dtype=x.dtype)


@register_op("crop", infer_shape=_crop_infer, grad=lambda op: [OpSpec(
    "crop_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def crop(ctx):
    """crop_op.h: the window of ``shape`` at ``offsets`` (the shape
    borrowed from input Y when given). A -1 entry takes the rest of that
    dim past its offset."""
    x = data_of(ctx.input("X"))
    if ctx.has_input("Y"):
        shape = tuple(data_of(ctx.input("Y")).shape)
    else:
        shape = tuple(int(s) for s in ctx.attr("shape"))
    offsets = [int(o) for o in ctx.attr("offsets", [0] * x.ndim)]
    sl = tuple(slice(o, xs if s == -1 else o + s)
               for s, xs, o in zip(shape, x.shape, offsets))
    ctx.set_output("Out", x[sl])


@register_op("crop_grad")
def crop_grad(ctx):
    x = data_of(ctx.input("X"))
    dy = data_of(ctx.input("Out@GRAD"))
    offsets = [int(o) for o in ctx.attr("offsets", [0] * x.ndim)]
    dx = torch.zeros(x.shape, dtype=dy.dtype, device=dy.device)
    sl = tuple(slice(o, o + ds) for o, ds in zip(offsets, dy.shape))
    dx[sl] = dy
    ctx.set_output("X@GRAD", dx)


# ---------------------------------------------------------------------------
# positive_negative_pair
# ---------------------------------------------------------------------------

@register_op("positive_negative_pair")
def positive_negative_pair(ctx):
    """positive_negative_pair_op.h: over the in-batch pairs that share a
    QueryID and differ in label, the weight of the pairs the score orders
    as the label does (positive), against it (negative) and tied
    (neutral), a pair weighing the mean of its two weights; added onto
    the Accumulate* inputs when given. A tied pair counts as neutral only,
    as in the reference's lowering."""
    score = data_of(ctx.input("Score"))
    label = data_of(ctx.input("Label")).reshape(-1)
    query = data_of(ctx.input("QueryID")).reshape(-1)
    col = int(ctx.attr("column", -1))
    s = score[:, col].reshape(-1)
    n = s.shape[0]
    w = data_of(ctx.input("Weight")).reshape(-1) \
        if ctx.has_input("Weight") \
        else torch.ones((n,), dtype=torch.float32, device=s.device)

    same_query = query[:, None] == query[None, :]
    diff_label = label[:, None] != label[None, :]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=s.device), diagonal=1)
    eligible = same_query & diff_label & upper
    pw = (w[:, None] + w[None, :]) * 0.5
    concord = (s[:, None] - s[None, :]) * (label[:, None] - label[None, :]) \
        > 0
    tied = s[:, None] == s[None, :]
    zero = torch.zeros((), dtype=pw.dtype, device=pw.device)
    pos = torch.where(eligible & ~tied & concord, pw, zero).sum()
    neg = torch.where(eligible & ~tied & ~concord, pw, zero).sum()
    neu = torch.where(eligible & tied, pw, zero).sum()
    for slot, val in (("PositivePair", pos), ("NegativePair", neg),
                      ("NeutralPair", neu)):
        acc = "Accumulate" + slot
        if ctx.has_input(acc):
            val = val + data_of(ctx.input(acc)).reshape(())
        ctx.set_output(slot, val.reshape((1,)))
