"""Activation ops (counterpart of paddle_tpu/ops/activation.py): one table
entry per activation, as the reference's ``_register_act`` (:20-52) builds
them, each a forward expression and a grad expression that reads Out or X
as the reference's grad functor does. Ported: sigmoid (reference :55),
relu (:60) and square (:80). LoD-transparent: a LoDArray input keeps its
lengths."""

from __future__ import annotations

import torch

from ..core.registry import register_op, same_shape, OpSpec, G
from .common import data_of, like


def _register_act(name, fwd, grad_fn, use="out"):
    """fwd(x) -> out; grad_fn(ref, dout) -> dx, where ref is Out or X as
    ``use`` says."""
    slot = {"out": "Out", "x": "X"}[use]

    def maker(op):
        ref = op.output("Out") if use == "out" else op.input("X")
        return [OpSpec(name + "_grad",
                       {slot: ref, "Out@GRAD": G(op.output("Out"))},
                       {"X@GRAD": G(op.input("X"))}, dict(op.attrs))]

    @register_op(name, infer_shape=same_shape("X", "Out"), grad=maker)
    def forward(ctx):
        x = ctx.input("X")
        ctx.set_output("Out", like(x, fwd(data_of(x))))

    @register_op(name + "_grad")
    def backward(ctx):
        d = ctx.input("Out@GRAD")
        ctx.set_output("X@GRAD", like(d, grad_fn(data_of(ctx.input(slot)),
                                                 data_of(d))))


_register_act("sigmoid", torch.sigmoid, lambda o, d: d * o * (1 - o))
_register_act("relu", lambda x: torch.clamp_min(x, 0),
              lambda o, d: d * (o > 0))
_register_act("square", torch.square, lambda x, d: 2.0 * d * x, use="x")
