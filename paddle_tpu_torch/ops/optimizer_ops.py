"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py):
the per-parameter ``momentum`` op (reference :115) and the variadic
``fused_momentum`` (reference :399), dense parameters only.

The update ops write ParamOut/VelocityOut under the parameter's and the
velocity's own names, so the executor writes the new values back to the
scope. ``fused_momentum`` sends its dense float32 parameters through ONE
arena kernel launch (``ops/cuda/optimizer.py``) when the tier takes the
kernel route, and otherwise applies the per-parameter expression to each,
so the fused and per-parameter programs agree bitwise under
``kernel_tier=torch``.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .cuda import use_kernel
from .cuda import optimizer as opk
from .cuda.optimizer import _momentum_dense


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


@register_op("momentum", in_place=True)
def momentum(ctx):
    p = ctx.input("Param")
    p_new, v_new = _momentum_dense(
        p, ctx.input("Grad").to(p.dtype), ctx.input("Velocity"), _lr(ctx),
        ctx.attr("mu"), ctx.attr("use_nesterov", False))
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("fused_momentum", in_place=True)
def fused_momentum(ctx):
    """Reference ``_fused_apply`` (:313-382) with the momentum body
    (:399-424): float32 parameters take the arena, the rest (and all of
    them under the plain route) ``_momentum_dense``."""
    lr = _lr(ctx)
    mu = ctx.attr("mu")
    nesterov = bool(ctx.attr("use_nesterov", False))
    ps, gs, vs = (ctx.inputs(s) for s in ("Params", "Grads", "Velocities"))
    p_out, v_out = [None] * len(ps), [None] * len(ps)
    fusable = [i for i, p in enumerate(ps) if p.dtype == torch.float32]
    device = ps[0].device if ps else torch.device("cpu")
    rest = range(len(ps))
    if use_kernel("optimizer", bool(fusable), device):
        new_p, new_v = opk.momentum_arena(
            [ps[i] for i in fusable],
            [gs[i].float().contiguous() for i in fusable],
            [vs[i] for i in fusable], lr, mu, nesterov)
        for i, p, v in zip(fusable, new_p, new_v):
            p_out[i], v_out[i] = p, v
        rest = sorted(set(rest) - set(fusable))
    for i in rest:
        p_out[i], v_out[i] = _momentum_dense(
            ps[i], gs[i].to(ps[i].dtype), vs[i], lr, mu, nesterov)
    ctx.set_outputs("ParamsOut", p_out)
    ctx.set_outputs("VelocitiesOut", v_out)
