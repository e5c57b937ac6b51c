"""Operator registry: per-op-type forward lowering, shape inference and
grad maker (counterpart of paddle_tpu/core/registry.py).

Every op has ONE ``forward(ctx)`` written on torch tensors. Hot ops route
through the kernel tier (``ops/cuda``) inside their forward. A grad maker
turns a forward op into the grad op specs ``fluid.backward.append_backward``
appends, the contract of the reference's GradOpDescMaker. An op may also
carry a declared slot arity (``SlotSpec``), which the program verifier
(``fluid/analysis``) checks.
"""

from __future__ import annotations

import dataclasses
import os
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
class SlotSpec:
    """Declared slot arity of an op type (reference :45), the analog of
    the OpProto input/output declarations. ``inputs``/``outputs`` map slot
    name -> arity marker: "1" exactly one var, "?" zero or one, "+" one or
    more, "*" any number. A slot not listed is an unknown name; an op
    without a SlotSpec is not arity-checked."""
    inputs: dict
    outputs: dict


@dataclasses.dataclass
class OpInfo:
    type: str
    # forward(ctx) -> None; reads ctx.input/attr, writes ctx.set_output
    forward: Callable
    # infer_shape(op, block) -> None; annotates output vars at build time
    infer_shape: Optional[Callable] = None
    # grad(op) -> list[OpSpec]; None means the op has no gradient
    grad: Optional[Callable] = None
    # control-flow ops (they run sub-blocks through ExecContext)
    is_control_flow: bool = False
    # outputs alias an input (optimizer ops write ParamOut == Param)
    in_place: bool = False
    # declared slot arity, set by register_slots (fluid/analysis/slots.py)
    slots: Optional[SlotSpec] = None


_REGISTRY: dict[str, OpInfo] = {}


def register_op(type, *, infer_shape=None, grad=None, is_control_flow=False,
                in_place=False):
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
                                 is_control_flow=is_control_flow,
                                 in_place=in_place)
        return fn
    return deco


def register_slots(type, inputs=None, outputs=None):
    """Attach a declared SlotSpec to a registered op type (reference
    :100); a second call replaces the first."""
    info = get_op_info(type)
    info.slots = SlotSpec(inputs=dict(inputs or {}),
                          outputs=dict(outputs or {}))
    return info.slots


def get_op_info(type) -> OpInfo:
    info = _REGISTRY.get(type)
    if info is None:
        raise KeyError(f"op {type!r} is not registered "
                       f"({len(_REGISTRY)} ops available)")
    return info


def has_op(type) -> bool:
    return type in _REGISTRY


def registered_ops():
    return sorted(_REGISTRY)


# ---- dispatch coverage (PDTPU_OP_COVERAGE=/path, reference :129-146) ----
# Op types that reach execution (the executor's op loop), appended one name
# per line; append mode merges processes. The executor records an op after
# its forward returns: graph building and append_backward look ops up too,
# so recording in get_op_info would overstate coverage.

_COVERAGE_PATH = os.environ.get("PDTPU_OP_COVERAGE")
_SEEN: set = set()


def dispatch_coverage_enabled():
    return bool(_COVERAGE_PATH)


def record_dispatch(type):
    if type in _SEEN:
        return
    try:
        with open(_COVERAGE_PATH, "a") as f:
            f.write(type + "\n")
    except OSError:
        return  # retried on the next dispatch: _SEEN only after success
    _SEEN.add(type)


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
