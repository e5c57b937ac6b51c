"""``paddle.v2.op`` — module-level math functions over layers.

Reference: python/paddle/v2/op.py — registers unary math ops
(exp/log/abs/... as paddle.op.exp(layer)) and the +,-,* operator overloads
on Layer. Here the unary functions delegate to the DSL's ``_unary_layer``
(the same lowering as ``layer_math``) and the arithmetic overloads already
live on LayerOutput (config_helpers ``_lo_binary`` / slope_intercept
semantics), so this module is the reference's module-spelling over the one
implementation.
"""

from __future__ import annotations

from .config_helpers import _unary_layer

__all__ = []


def _register(op_name):
    def op(input, name=None):
        return _unary_layer(op_name, input, name=name)

    op.__name__ = op_name
    globals()[op_name] = op
    __all__.append(op_name)


for _name in ("exp", "log", "abs", "sigmoid", "tanh", "square", "relu",
              "sqrt", "reciprocal", "softmax"):
    _register(_name)
