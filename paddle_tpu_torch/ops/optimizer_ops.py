"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py):
the per-parameter ``sgd`` (reference :108), ``momentum`` (:115), ``adam``
(:139), ``adagrad`` (:168), ``decayed_adagrad`` (:189), ``adadelta``
(:200), ``rmsprop`` (:215), ``adamax`` (:230), ``ftrl`` (:246),
``proximal_gd`` (:271) and ``proximal_adagrad`` (:283), and the
variadic ``fused_sgd``, ``fused_momentum`` and ``fused_adam`` (:385, :399,
:427). Each keeps the reference op's attribute defaults.

The update ops write their outputs under the parameter's and the state's
own names, so the executor writes the new values back to the scope. A
fused op sends its dense float32 parameters through ONE arena kernel
launch (``ops/cuda/optimizer.py``) when the tier takes the kernel route,
and otherwise applies the per-parameter expression to each, so the fused
and per-parameter programs agree bitwise under ``kernel_tier=torch``.

A ``SparseRows`` gradient (an ``is_sparse`` embedding's) takes the sparse
branch in every op, fused or not: SGD's runs the embedding kernel
(``ops/cuda/embedding.py``, the merge fused in) on the kernel route and
the unmerged scatter-add of ``−lr·vals`` on the plain route (reference
:79-105); momentum's and Adam's merge the rows and update only the touched
rows of the parameter and its state (``core/sparse.py::apply_rowwise``,
reference :122-135, :149-165: the lazy update), and so does adagrad's
(:174-182). The other seven densify a sparse gradient (``_param_grad``).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.sparse import apply_rowwise, is_sparse
from .autotune import dispatch_variant, dtype_str, make_key
from .cuda import embedding as embk
from .cuda import optimizer as opk
from .cuda.optimizer import _adam_dense, _momentum_dense, _sgd_dense, adam_lr


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


def _param_grad(ctx):
    """Param and Grad, the gradient densified if sparse and cast to the
    parameter's dtype (reference :37): the optimizers with no sparse
    branch."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    if is_sparse(g):
        g = g.to_dense()
    return p, g.to(p.dtype)


def _adam_attrs(ctx):
    return (ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999),
            ctx.attr("epsilon", 1e-8))


def _sgd_apply(p, g, lr):
    """One parameter's SGD step: the dense expression, or the sparse
    branch (reference :79-105). On the kernel route a supported table runs
    the embedding kernel, which merges the rows and updates the touched
    ones; otherwise the unmerged scatter-add, which needs no merge (the
    update is linear, so duplicates accumulate)."""
    if is_sparse(g):
        vals = g.values.to(p.dtype)
        key = make_key(rows=int(p.shape[0]),
                       dim=int(p.shape[1]) if p.ndim == 2 else 0,
                       nnz=int(g.values.shape[0]), dtype=dtype_str(p.dtype))
        choice = dispatch_variant(
            "embedding", key, {"jnp": True,
                               "pallas": embk.supported(p, vals)},
            tier_kernel="embedding_sgd", device=p.device)
        if choice == "pallas":
            return embk.embedding_sgd(p, g.rows, vals.contiguous(), lr)
        return embk.embedding_sgd_scatter(p, g.rows, vals, lr)
    return _sgd_dense(p, g.to(p.dtype), lr)


def _momentum_sparse(p, g, v, lr, mu, nesterov):
    """The lazy momentum step of the rows a SparseRows gradient touches
    (reference :122-135)."""
    return tuple(apply_rowwise(
        g.astype(p.dtype), [p, v],
        lambda gr, pr, vr: _momentum_dense(pr, gr, vr, lr, mu, nesterov)))


def _adam_sparse(p, g, m1, m2, lr_eff, b1, b2, eps):
    """The lazy Adam step of the rows a SparseRows gradient touches
    (reference :149-165, the reference's SparseAdamFunctor)."""
    return tuple(apply_rowwise(
        g.astype(p.dtype), [p, m1, m2],
        lambda gr, pr, m1r, m2r: _adam_dense(pr, gr, m1r, m2r, lr_eff, b1,
                                             b2, eps)))


@register_op("sgd", in_place=True)
def sgd(ctx):
    ctx.set_output("ParamOut", _sgd_apply(ctx.input("Param"),
                                          ctx.input("Grad"), _lr(ctx)))


@register_op("momentum", in_place=True)
def momentum(ctx):
    p, g, v = ctx.input("Param"), ctx.input("Grad"), ctx.input("Velocity")
    args = (_lr(ctx), ctx.attr("mu"), ctx.attr("use_nesterov", False))
    p_new, v_new = _momentum_sparse(p, g, v, *args) if is_sparse(g) \
        else _momentum_dense(p, g.to(p.dtype), v, *args)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("adam", in_place=True)
def adam(ctx):
    """One parameter's Adam step with its own beta-power pair (Adam
    appends the pair's ``scale`` updates after this op)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    lr_eff = adam_lr(_lr(ctx), ctx.input("Beta1Pow").reshape(()),
                     ctx.input("Beta2Pow").reshape(()))
    args = (lr_eff, *_adam_attrs(ctx))
    p_new, m1n, m2n = _adam_sparse(p, g, m1, m2, *args) if is_sparse(g) \
        else _adam_dense(p, g.to(p.dtype), m1, m2, *args)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("Moment1Out", m1n)
    ctx.set_output("Moment2Out", m2n)


def _fused_apply(ctx, state_slots, out_slots, dense_fn, sparse_fn, arena_fn):
    """The shared body of the fused ops (reference :313-382): parameters
    with a dense gradient and a float32 value go through ONE arena launch
    (``arena_fn(ps, gs, *states)`` returns the updated lists) under the
    kernel route; a SparseRows gradient goes through ``sparse_fn(p, g,
    *states)`` (reference :334-345); the rest, and all dense ones under the
    plain route, through ``dense_fn(p, g, *states)``, the per-parameter
    expression. Each returns (p_new, *state_news)."""
    slots = ("Params", "Grads") + tuple(state_slots)
    entries = list(zip(*[ctx.inputs(s) for s in slots]))
    outs = [[None] * len(entries) for _ in out_slots]
    fusable = [i for i, e in enumerate(entries)
               if not is_sparse(e[1]) and e[0].dtype == torch.float32]
    device = entries[0][0].device if entries else torch.device("cpu")
    rest = range(len(entries))
    # the dispatch runs even with no fusable params, so that an all-sparse
    # op under a kernel tier is a counted fallback, as the reference's is
    kind = {0: "sgd", 1: "momentum"}.get(len(state_slots), "adam")
    elems = sum(int(entries[i][0].numel()) for i in fusable)
    choice = dispatch_variant(
        "optimizer", make_key(kind=kind, tensors=len(fusable), elems=elems),
        {"jnp": True, "pallas": bool(fusable)}, device=device)
    if choice == "pallas":
        results = arena_fn(*[[entries[i][j].float().contiguous() if j == 1
                              else entries[i][j] for i in fusable]
                             for j in range(len(slots))])
        for j, vals in enumerate(results):
            for i, v in zip(fusable, vals):
                outs[j][i] = v
        rest = sorted(set(rest) - set(fusable))
    for i in rest:
        p, g, *states = entries[i]
        res = sparse_fn(p, g, *states) if is_sparse(g) \
            else dense_fn(p, g.to(p.dtype), *states)
        for j, v in enumerate(res):
            outs[j][i] = v
    for slot, vals in zip(out_slots, outs):
        ctx.set_outputs(slot, vals)


@register_op("fused_sgd", in_place=True)
def fused_sgd(ctx):
    """Every parameter's SGD step (reference :385-396)."""
    lr = _lr(ctx)
    _fused_apply(
        ctx, (), ("ParamsOut",),
        lambda p, g: (_sgd_dense(p, g, lr),),
        lambda p, g: (_sgd_apply(p, g, lr),),
        lambda ps, gs: (opk.sgd_arena(ps, gs, lr),))


@register_op("fused_momentum", in_place=True)
def fused_momentum(ctx):
    """Every parameter's momentum step (reference :399-424)."""
    args = (_lr(ctx), ctx.attr("mu"), bool(ctx.attr("use_nesterov", False)))
    _fused_apply(
        ctx, ("Velocities",), ("ParamsOut", "VelocitiesOut"),
        lambda p, g, v: _momentum_dense(p, g, v, *args),
        lambda p, g, v: _momentum_sparse(p, g, v, *args),
        lambda ps, gs, vs: opk.momentum_arena(ps, gs, vs, *args))


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
        lambda p, g, m1, m2: _adam_sparse(p, g, m1, m2, lr_eff, b1, b2, eps),
        lambda ps, gs, m1s, m2s: opk.adam_arena(
            ps, gs, m1s, m2s, lr, b1p, b2p, b1, b2, eps))


@register_op("adagrad", in_place=True)
def adagrad(ctx):
    """m += g²; p -= lr·g / (√m + ε) (reference :168); a SparseRows
    gradient updates only its merged rows (:174-182)."""
    p, m = ctx.input("Param"), ctx.input("Moment")
    eps, lr = ctx.attr("epsilon", 1e-6), _lr(ctx)

    def upd(g, p_r, m_r):
        m_new = m_r + g * g
        return p_r - lr * g / (torch.sqrt(m_new) + eps), m_new

    g = ctx.input("Grad")
    if is_sparse(g):
        p_new, m_new = apply_rowwise(g.astype(p.dtype), [p, m], upd)
    else:
        p_new, m_new = upd(g.to(p.dtype), p, m)
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("MomentOut", m_new)


@register_op("decayed_adagrad", in_place=True)
def decayed_adagrad(ctx):
    """m = decay·m + (1 − decay)·g²; p -= lr·g / (√m + ε) (reference
    :189)."""
    p, g = _param_grad(ctx)
    m = ctx.input("Moment")
    decay, eps = ctx.attr("decay", 0.95), ctx.attr("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    ctx.set_output("ParamOut", p - _lr(ctx) * g / (torch.sqrt(m_new) + eps))
    ctx.set_output("MomentOut", m_new)


@register_op("adadelta", in_place=True)
def adadelta(ctx):
    """Adadelta (reference :200); LearningRate is read by no expression, as
    in the reference."""
    p, g = _param_grad(ctx)
    avg_sq_grad = ctx.input("AvgSquaredGrad")
    avg_sq_upd = ctx.input("AvgSquaredUpdate")
    rho, eps = ctx.attr("rho", 0.95), ctx.attr("epsilon", 1e-6)
    asg = rho * avg_sq_grad + (1 - rho) * g * g
    upd = -torch.sqrt((avg_sq_upd + eps) / (asg + eps)) * g
    asu = rho * avg_sq_upd + (1 - rho) * upd * upd
    ctx.set_output("ParamOut", p + upd)
    ctx.set_output("AvgSquaredGradOut", asg)
    ctx.set_output("AvgSquaredUpdateOut", asu)


@register_op("rmsprop", in_place=True)
def rmsprop(ctx):
    """ms = ρ·ms + (1 − ρ)·g²; mom = μ·mom + lr·g / √(ms + ε); p -= mom
    (reference :215). The op's defaults are decay 0.9 and epsilon 1e-10;
    the RMSProp class passes its own."""
    p, g = _param_grad(ctx)
    ms, mom = ctx.input("MeanSquare"), ctx.input("Moment")
    rho, eps = ctx.attr("decay", 0.9), ctx.attr("epsilon", 1e-10)
    momentum_c = ctx.attr("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    mom_new = momentum_c * mom + _lr(ctx) * g / torch.sqrt(ms_new + eps)
    ctx.set_output("ParamOut", p - mom_new)
    ctx.set_output("MeanSquareOut", ms_new)
    ctx.set_output("MomentOut", mom_new)


@register_op("adamax", in_place=True)
def adamax(ctx):
    """m = β1·m + (1 − β1)·g; u = max(β2·u, |g| + ε); p -= lr / (1 −
    β1^t) · m / u (reference :230); Adamax appends the beta1_pow scale."""
    p, g = _param_grad(ctx)
    m, inf_norm = ctx.input("Moment"), ctx.input("InfNorm")
    b1p = ctx.input("Beta1Pow").reshape(())
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf_norm, torch.abs(g) + eps)
    lr = _lr(ctx) / (1 - b1p)
    ctx.set_output("ParamOut", p - lr * m_new / inf_new)
    ctx.set_output("MomentOut", m_new)
    ctx.set_output("InfNormOut", inf_new)


@register_op("ftrl", in_place=True)
def ftrl(ctx):
    """FTRL-proximal (reference :246), with its square-root branch for
    ``lr_power`` −0.5 and the power branch otherwise."""
    p, g = _param_grad(ctx)
    sq, lin = ctx.input("SquaredAccumulator"), ctx.input("LinearAccumulator")
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(ctx)
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (torch.pow(new_sq, -lr_power)
                 - torch.pow(sq, -lr_power)) / lr
    new_lin = lin + g - sigma * p
    x = torch.clamp(new_lin, -l1, l1) - new_lin
    if lr_power == -0.5:
        y = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        y = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    ctx.set_output("ParamOut", x / y)
    ctx.set_output("SquaredAccumOut", new_sq)
    ctx.set_output("LinearAccumOut", new_lin)


def _proximal(p, g, lr, l1, l2):
    """The proximal step: p - lr·g shrunk by lr·l1 towards 0 and divided
    by 1 + lr·l2 (proximal_gd_op.h, proximal_adagrad_op.h)."""
    prox = p - lr * g
    return torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1,
                                              0.0) / (1.0 + lr * l2)


@register_op("proximal_gd", in_place=True)
def proximal_gd(ctx):
    p, g = _param_grad(ctx)
    ctx.set_output("ParamOut", _proximal(p, g, _lr(ctx),
                                         ctx.attr("l1", 0.0),
                                         ctx.attr("l2", 0.0)))


@register_op("proximal_adagrad", in_place=True)
def proximal_adagrad(ctx):
    """proximal_gd with the rate divided by sqrt of the summed squared
    gradients."""
    p, g = _param_grad(ctx)
    m_new = ctx.input("Moment") + g * g
    ctx.set_output("ParamOut", _proximal(p, g, _lr(ctx) / torch.sqrt(m_new),
                                         ctx.attr("l1", 0.0),
                                         ctx.attr("l2", 0.0)))
    ctx.set_output("MomentOut", m_new)
