"""Activation ops (counterpart of paddle_tpu/ops/activation.py): one table
entry per activation, as the reference's ``_register_act`` (:20-52) builds
them, each a forward expression and a grad expression that reads Out or X
as the reference's grad functor does, with the reference's attribute
defaults. All 28 kinds of the reference's table (:55-124). LoD-transparent:
a LoDArray input keeps its lengths."""

from __future__ import annotations

import torch

from ..core.registry import register_op, same_shape, OpSpec, G
from .common import data_of, like


def _register_act(name, fwd, grad_fn, use="out"):
    """fwd(x, attr) -> out; grad_fn(ref, dout, attr) -> dx, where ref is
    Out or X as ``use`` says and ``attr(name, default)`` reads the op's
    attributes."""
    slot = {"out": "Out", "x": "X"}[use]

    def maker(op):
        ref = op.output("Out") if use == "out" else op.input("X")
        return [OpSpec(name + "_grad",
                       {slot: ref, "Out@GRAD": G(op.output("Out"))},
                       {"X@GRAD": G(op.input("X"))}, dict(op.attrs))]

    @register_op(name, infer_shape=same_shape("X", "Out"), grad=maker)
    def forward(ctx):
        x = ctx.input("X")
        ctx.set_output("Out", like(x, fwd(data_of(x), ctx.attr)))

    @register_op(name + "_grad")
    def backward(ctx):
        d = ctx.input("Out@GRAD")
        ctx.set_output("X@GRAD", like(d, grad_fn(data_of(ctx.input(slot)),
                                                 data_of(d), ctx.attr)))


def _pick(cond, a, b, x):
    """``a`` where ``cond`` else ``b``, two Python scalars, in x's dtype
    (the reference's ``jnp.where(cond, 1.0, alpha)``)."""
    return torch.where(cond, torch.full_like(x, a), torch.full_like(x, b))


def _softplus(x):
    return torch.logaddexp(torch.zeros_like(x), x)


_A = _register_act

_A("sigmoid", lambda x, a: torch.sigmoid(x),
   lambda o, d, a: d * o * (1 - o))
_A("logsigmoid", lambda x, a: -_softplus(-x),
   lambda x, d, a: d * (1.0 / (1.0 + torch.exp(x))), "x")
_A("exp", lambda x, a: torch.exp(x), lambda o, d, a: d * o)
_A("relu", lambda x, a: torch.clamp_min(x, 0),
   lambda o, d, a: d * (o > 0))
_A("tanh", lambda x, a: torch.tanh(x), lambda o, d, a: d * (1 - o * o))
_A("tanh_shrink", lambda x, a: x - torch.tanh(x),
   lambda x, d, a: d * torch.square(torch.tanh(x)), "x")
_A("softshrink",
   lambda x, a: torch.where(
       x > a("lambda", 0.5), x - a("lambda", 0.5),
       torch.where(x < -a("lambda", 0.5), x + a("lambda", 0.5), 0.0)),
   lambda x, d, a: d * ((x > a("lambda", 0.5)) | (x < -a("lambda", 0.5))),
   "x")
_A("sqrt", lambda x, a: torch.sqrt(x), lambda o, d, a: d * 0.5 / o)
_A("abs", lambda x, a: torch.abs(x), lambda x, d, a: d * torch.sign(x), "x")
_A("ceil", lambda x, a: torch.ceil(x),
   lambda x, d, a: torch.zeros_like(d), "x")
_A("floor", lambda x, a: torch.floor(x),
   lambda x, d, a: torch.zeros_like(d), "x")
_A("round", lambda x, a: torch.round(x),
   lambda x, d, a: torch.zeros_like(d), "x")
_A("reciprocal", lambda x, a: 1.0 / x, lambda o, d, a: -d * o * o)
_A("log", lambda x, a: torch.log(x), lambda x, d, a: d / x, "x")
_A("square", lambda x, a: torch.square(x), lambda x, d, a: 2.0 * d * x, "x")
_A("softplus", lambda x, a: _softplus(x),
   lambda x, d, a: d * (1.0 / (1.0 + torch.exp(-x))), "x")
_A("softsign", lambda x, a: x / (1 + torch.abs(x)),
   lambda x, d, a: d / torch.square(1 + torch.abs(x)), "x")
_A("brelu",
   lambda x, a: torch.clamp(x, a("t_min", 0.0), a("t_max", 24.0)),
   lambda x, d, a: d * ((x > a("t_min", 0.0)) & (x < a("t_max", 24.0))),
   "x")
_A("leaky_relu",
   lambda x, a: torch.where(x >= 0, x, a("alpha", 0.02) * x),
   lambda x, d, a: d * _pick(x >= 0, 1.0, a("alpha", 0.02), x), "x")
_A("soft_relu",
   lambda x, a: torch.log1p(torch.exp(torch.clamp(
       x, -a("threshold", 40.0), a("threshold", 40.0)))),
   lambda o, d, a: d * (1 - torch.exp(-o)))
_A("elu",
   lambda x, a: torch.where(x >= 0, x,
                            a("alpha", 1.0) * (torch.exp(x) - 1)),
   lambda x, d, a: d * torch.where(x >= 0, torch.ones_like(x),
                                   a("alpha", 1.0) * torch.exp(x)), "x")
_A("relu6", lambda x, a: torch.clamp(x, 0.0, a("threshold", 6.0)),
   lambda x, d, a: d * ((x > 0) & (x < a("threshold", 6.0))), "x")
_A("pow", lambda x, a: torch.pow(x, a("factor", 1.0)),
   lambda x, d, a: d * a("factor", 1.0)
   * torch.pow(x, a("factor", 1.0) - 1), "x")
_A("stanh",
   lambda x, a: a("scale_b", 1.7159) * torch.tanh(a("scale_a", 0.67) * x),
   lambda x, d, a: d * a("scale_a", 0.67) * a("scale_b", 1.7159)
   * (1 - torch.square(torch.tanh(a("scale_a", 0.67) * x))), "x")
_A("hard_shrink",
   lambda x, a: torch.where((x > a("threshold", 0.5))
                            | (x < -a("threshold", 0.5)), x, 0.0),
   lambda x, d, a: d * ((x > a("threshold", 0.5))
                        | (x < -a("threshold", 0.5))), "x")
_A("thresholded_relu",
   lambda x, a: torch.where(x > a("threshold", 1.0), x, 0.0),
   lambda x, d, a: d * (x > a("threshold", 1.0)), "x")
_A("hard_sigmoid",
   lambda x, a: torch.clamp(a("slope", 0.2) * x + a("offset", 0.5), 0.0,
                            1.0),
   lambda x, d, a: d * _pick(
       (a("slope", 0.2) * x + a("offset", 0.5) > 0)
       & (a("slope", 0.2) * x + a("offset", 0.5) < 1),
       a("slope", 0.2), 0.0, x), "x")
_A("swish",
   lambda x, a: x / (1 + torch.exp(-a("beta", 1.0) * x)),
   lambda x, d, a: d * ((1 + torch.exp(-a("beta", 1.0) * x)
                         + a("beta", 1.0) * x
                         * torch.exp(-a("beta", 1.0) * x))
                        / torch.square(1 + torch.exp(-a("beta", 1.0) * x))),
   "x")
