"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py):
the per-parameter ``momentum`` (reference :115) and ``adam`` (reference
:139) ops and the variadic ``fused_momentum`` and ``fused_adam``
(reference :399, :427), dense parameters only.

The update ops write their outputs under the parameter's and the state's
own names, so the executor writes the new values back to the scope. A
fused op sends its dense float32 parameters through ONE arena kernel
launch (``ops/cuda/optimizer.py``) when the tier takes the kernel route,
and otherwise applies the per-parameter expression to each, so the fused
and per-parameter programs agree bitwise under ``kernel_tier=torch``.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .cuda import use_kernel
from .cuda import optimizer as opk
from .cuda.optimizer import _adam_dense, _momentum_dense, adam_lr


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


def _adam_attrs(ctx):
    return (ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999),
            ctx.attr("epsilon", 1e-8))


@register_op("momentum", in_place=True)
def momentum(ctx):
    p = ctx.input("Param")
    p_new, v_new = _momentum_dense(
        p, ctx.input("Grad").to(p.dtype), ctx.input("Velocity"), _lr(ctx),
        ctx.attr("mu"), ctx.attr("use_nesterov", False))
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("adam", in_place=True)
def adam(ctx):
    """One parameter's Adam step with its own beta-power pair (Adam
    appends the pair's ``scale`` updates after this op)."""
    p = ctx.input("Param")
    b1, b2, eps = _adam_attrs(ctx)
    lr_eff = adam_lr(_lr(ctx), ctx.input("Beta1Pow").reshape(()),
                     ctx.input("Beta2Pow").reshape(()))
    p_new, m1n, m2n = _adam_dense(p, ctx.input("Grad").to(p.dtype),
                                  ctx.input("Moment1"), ctx.input("Moment2"),
                                  lr_eff, b1, b2, eps)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("Moment1Out", m1n)
    ctx.set_output("Moment2Out", m2n)


def _fused_apply(ctx, state_slots, out_slots, dense_fn, arena_fn):
    """The shared body of the fused ops (reference :313-382): float32
    parameters go through ONE arena launch (``arena_fn(ps, gs, *states)``
    returns the updated lists) under the kernel route, the rest, and all of
    them under the plain route, through ``dense_fn(p, g, *states)``, the
    per-parameter expression. Each returns (p_new, *state_news)."""
    slots = ("Params", "Grads") + tuple(state_slots)
    entries = list(zip(*[ctx.inputs(s) for s in slots]))
    outs = [[None] * len(entries) for _ in out_slots]
    fusable = [i for i, e in enumerate(entries) if e[0].dtype == torch.float32]
    device = entries[0][0].device if entries else torch.device("cpu")
    rest = range(len(entries))
    if use_kernel("optimizer", bool(fusable), device):
        results = arena_fn(*[[entries[i][j].float().contiguous() if j == 1
                              else entries[i][j] for i in fusable]
                             for j in range(len(slots))])
        for j, vals in enumerate(results):
            for i, v in zip(fusable, vals):
                outs[j][i] = v
        rest = sorted(set(rest) - set(fusable))
    for i in rest:
        p, g, *states = entries[i]
        for j, v in enumerate(dense_fn(p, g.to(p.dtype), *states)):
            outs[j][i] = v
    for slot, vals in zip(out_slots, outs):
        ctx.set_outputs(slot, vals)


@register_op("fused_momentum", in_place=True)
def fused_momentum(ctx):
    """Every parameter's momentum step (reference :399-424)."""
    lr = _lr(ctx)
    mu = ctx.attr("mu")
    nesterov = bool(ctx.attr("use_nesterov", False))
    _fused_apply(
        ctx, ("Velocities",), ("ParamsOut", "VelocitiesOut"),
        lambda p, g, v: _momentum_dense(p, g, v, lr, mu, nesterov),
        lambda ps, gs, vs: opk.momentum_arena(ps, gs, vs, lr, mu, nesterov))


@register_op("fused_adam", in_place=True)
def fused_adam(ctx):
    """Every parameter's Adam step with ONE shared beta-power pair
    (reference :427-456): every parameter shares the step count, so lr_eff
    is one scalar for the whole arena."""
    lr = _lr(ctx)
    b1p = ctx.input("Beta1Pow").reshape(())
    b2p = ctx.input("Beta2Pow").reshape(())
    b1, b2, eps = _adam_attrs(ctx)
    lr_eff = adam_lr(lr, b1p, b2p)
    _fused_apply(
        ctx, ("Moment1s", "Moment2s"),
        ("ParamsOut", "Moment1sOut", "Moment2sOut"),
        lambda p, g, m1, m2: _adam_dense(p, g, m1, m2, lr_eff, b1, b2, eps),
        lambda ps, gs, m1s, m2s: opk.adam_arena(
            ps, gs, m1s, m2s, lr, b1p, b2p, b1, b2, eps))
