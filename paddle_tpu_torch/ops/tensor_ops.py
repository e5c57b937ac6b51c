"""Creation ops, concat, the variadic sum and top_k (counterpart of
paddle_tpu/ops/tensor_ops.py): fill_constant, fill_zeros_like,
uniform_random, gaussian_random, concat and its grad, sum, scale and
top_k. fill_zeros_like, concat, sum, scale and top_k are LoD-transparent:
a LoDArray input keeps its lengths, so the padded positions of a LoD
gradient stay masked downstream. ``sum`` also adds SparseRows gradients.

Random ops draw from the executor's ``torch.Generator``, seeded once per
scope from ``Program.random_seed``. They do not reproduce the reference's
jax.random draws; cross-package tests copy parameters instead.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, same_shape, OpSpec, G
from ..core.sparse import SparseRows, is_sparse
from ..core.types import torch_dtype
from .common import data_of, like


@register_op("fill_constant")
def fill_constant(ctx):
    ctx.set_output("Out", torch.full(
        tuple(ctx.attr("shape", [])), ctx.attr("value", 0.0),
        dtype=torch_dtype(ctx.attr("dtype", "float32")), device=ctx.device))


@register_op("fill_zeros_like", infer_shape=same_shape("X", "Out"))
def fill_zeros_like(ctx):
    """Zeros shaped like X (reference :52): the grad of a forward output no
    grad op produced."""
    x = ctx.input("X")
    ctx.set_output("Out", like(x, torch.zeros_like(data_of(x))))


@register_op("uniform_random")
def uniform_random(ctx):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    out = torch.rand(tuple(ctx.attr("shape")), generator=ctx.generator(),
                     dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (out * (hi - lo) + lo).to(
        torch_dtype(ctx.attr("dtype", "float32"))))


@register_op("gaussian_random")
def gaussian_random(ctx):
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    out = torch.randn(tuple(ctx.attr("shape")), generator=ctx.generator(),
                      dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (mean + std * out).to(
        torch_dtype(ctx.attr("dtype", "float32"))))


def _concat_axis(ctx, vs):
    """LoD inputs see the reference's flat [rows, feat] axis numbering; the
    padded [b, T, feat] layout shifts positive axes by one (reference
    :249)."""
    axis = ctx.attr("axis", 0)
    if any(isinstance(v, LoDArray) for v in vs) and axis >= 0:
        if axis == 0:
            raise ValueError("concat along the LoD rows axis is not "
                             "supported; use sequence_concat")
        axis += 1
    return axis


@register_op("concat", grad=lambda op: [OpSpec(
    "concat_grad",
    {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def concat(ctx):
    """The inputs joined along ``axis`` (reference :262)."""
    vs = ctx.inputs("X")
    out = torch.cat([data_of(v) for v in vs], dim=_concat_axis(ctx, vs))
    ctx.set_output("Out", like(vs[0], out))


@register_op("concat_grad")
def concat_grad(ctx):
    """Out@GRAD split back into the inputs' widths (reference :272)."""
    vs = ctx.inputs("X")
    axis = _concat_axis(ctx, vs)
    d = data_of(ctx.input("Out@GRAD"))
    parts = torch.split(d, [data_of(v).shape[axis] for v in vs], dim=axis)
    ctx.set_outputs("X@GRAD", [like(v, p.contiguous())
                               for v, p in zip(vs, parts)])


@register_op("sum")
def sum_op(ctx):
    """Variadic sum, added left to right (reference :298): the
    backward's rename-and-sum of repeated gradients. All-SparseRows inputs
    concatenate their entries in input order (the reference's sum over
    SelectedRows appends rows); a mix of dense and sparse densifies the
    sparse terms (reference :319-330). Its grad maker (an assign per input)
    is not ported: no ported program differentiates a sum."""
    vs = ctx.inputs("X")
    if any(is_sparse(v) for v in vs):
        if all(is_sparse(v) for v in vs):
            ctx.set_output("Out", SparseRows(
                torch.cat([v.rows for v in vs]),
                torch.cat([v.values for v in vs]), vs[0].nrows))
            return
        vs = [v.to_dense() if is_sparse(v) else v for v in vs]
    out = data_of(vs[0])
    for v in vs[1:]:
        out = out + data_of(v)
    ctx.set_output("Out", like(vs[0], out))


@register_op("scale", infer_shape=same_shape("X", "Out"))
def scale(ctx):
    """Out = X·scale + bias (reference :108): the beta-power update that
    Adam appends after its update op. Its grad maker (a scale of the output
    grad) is not ported: no ported program differentiates a scale."""
    x = ctx.input("X")
    ctx.set_output("Out", like(x, data_of(x) * ctx.attr("scale", 1.0)
                             + ctx.attr("bias", 0.0)))


@register_op("top_k")
def top_k(ctx):
    """The k largest entries of the last axis and their int64 indices
    (reference :395), in descending order, the lower index first among
    equal values (as jax.lax.top_k). Float32 is ordered as XLA's sort
    orders it, by the IEEE total order (-0.0 below +0.0). Out and Indices
    keep X's LoD: the ctc_greedy_decoder path takes the arg-max of ragged
    logits."""
    xin = ctx.input("X")
    x = data_of(xin)
    key = x
    if x.dtype == torch.float32:
        bits = x.view(torch.int32)
        key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True,
                     stable=True).indices[..., :ctx.attr("k", 1)]
    ctx.set_output("Out", like(xin, torch.gather(x, -1, idx)))
    ctx.set_output("Indices", like(xin, idx))
