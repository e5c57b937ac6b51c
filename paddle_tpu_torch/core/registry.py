"""Operator registry: per-op-type forward lowering, shape inference and
grad maker (counterpart of paddle_tpu/core/registry.py).

Every op has ONE ``forward(ctx)`` written on torch tensors. Hot ops route
through the kernel tier (``ops/cuda``) inside their forward. A grad maker
turns a forward op into the grad op specs ``fluid.backward.append_backward``
appends, the contract of the reference's GradOpDescMaker.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


# the gradient-variable suffix (fluid.framework.grad_var_name)
GRAD_SUFFIX = "@GRAD"


def G(names):
    """Names -> their gradient-variable names (reference ops/common.py)."""
    if isinstance(names, str):
        return names + GRAD_SUFFIX
    return [n + GRAD_SUFFIX for n in names]


@dataclasses.dataclass
class OpSpec:
    """A to-be-appended op description returned by grad makers."""
    type: str
    inputs: dict
    outputs: dict
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OpInfo:
    type: str
    # forward(ctx) -> None; reads ctx.input/attr, writes ctx.set_output
    forward: Callable
    # infer_shape(op, block) -> None; annotates output vars at build time
    infer_shape: Optional[Callable] = None
    # grad(op) -> list[OpSpec]; None means the op has no gradient
    grad: Optional[Callable] = None
    # outputs alias an input (optimizer ops write ParamOut == Param)
    in_place: bool = False


_REGISTRY: dict[str, OpInfo] = {}


def register_op(type, *, infer_shape=None, grad=None, in_place=False):
    """Decorator registering ``forward`` for an op type::

        @register_op("relu", infer_shape=same_shape("X", "Out"),
                     grad=relu_grad_maker)
        def relu(ctx):
            ctx.set_output("Out", torch.clamp_min(ctx.input("X"), 0))
    """
    def deco(fn):
        if type in _REGISTRY:
            raise KeyError(f"op {type!r} registered twice")
        _REGISTRY[type] = OpInfo(type=type, forward=fn,
                                 infer_shape=infer_shape, grad=grad,
                                 in_place=in_place)
        return fn
    return deco


def get_op_info(type) -> OpInfo:
    info = _REGISTRY.get(type)
    if info is None:
        raise KeyError(f"op {type!r} is not registered "
                       f"({len(_REGISTRY)} ops available)")
    return info


# ---- common infer_shape helpers ----

def same_shape(src_slot="X", dst_slot="Out"):
    """Output takes the shape/dtype/lod of the (first) input."""
    def infer(op, block):
        x = block.var(op.input(src_slot)[0])
        for name in op.output(dst_slot):
            out = block.var(name)
            out.shape = x.shape
            if out.dtype is None:
                out.dtype = x.dtype
            out.lod_level = x.lod_level
    return infer


def infer_output(op, block, slot, shape, dtype=None, lod_level=None):
    for name in op.output(slot):
        v = block.var(name)
        v.shape = tuple(int(s) for s in shape)
        if dtype is not None:
            v.dtype = dtype
        if lod_level is not None:
            v.lod_level = lod_level
