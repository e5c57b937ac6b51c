"""Creation ops and the variadic sum (counterpart of
paddle_tpu/ops/tensor_ops.py): fill_constant, fill_zeros_like,
uniform_random, gaussian_random, sum and scale. fill_zeros_like, sum and
scale are LoD-transparent: a LoDArray input keeps its lengths, so the
padded positions of a LoD gradient stay masked downstream.

Random ops draw from the executor's ``torch.Generator``, seeded once per
scope from ``Program.random_seed``. They do not reproduce the reference's
jax.random draws; cross-package tests copy parameters instead.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op, same_shape
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


@register_op("sum")
def sum_op(ctx):
    """Variadic sum, added left to right (reference :298): the
    backward's rename-and-sum of repeated gradients. Its grad maker (an
    assign per input) is not ported: no ported program differentiates a
    sum."""
    vs = ctx.inputs("X")
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
