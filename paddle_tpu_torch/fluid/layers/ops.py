"""Generated layer wrappers of single-input ops (counterpart of
paddle_tpu/fluid/layers/ops.py): one layer per unary op of the reference's
``_UNARY_OPS`` (:14-20), extra keyword arguments passed as the op's
attributes; ``clip`` and ``clip_by_norm`` (:78-96) and the logical ops
(:97-117). The ``reduce_*`` wrappers wait for the reduce ops."""

from __future__ import annotations

import sys

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
    "softshrink", "sqrt", "abs", "ceil", "floor", "round", "reciprocal",
    "log", "square", "softplus", "softsign", "brelu", "leaky_relu",
    "soft_relu", "elu", "relu6", "pow", "stanh", "hard_shrink",
    "thresholded_relu", "hard_sigmoid", "swish", "sign",
]


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                         lod_level=x.lod_level)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


_mod = sys.modules[__name__]
for _t in _UNARY_OPS:
    setattr(_mod, _t, _make_unary(_t))


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op("clip", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("clip_by_norm", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"max_norm": float(max_norm)})
    return out


def _make_logical(op_type, binary=True):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_tmp_variable("bool", shape=x.shape,
                                             stop_gradient=True)
        inputs = {"X": [x.name]}
        if binary:
            inputs["Y"] = [y.name]
        helper.append_op(op_type, inputs=inputs,
                         outputs={"Out": [out.name]})
        return out
    layer.__name__ = op_type
    return layer


logical_and = _make_logical("logical_and")
logical_or = _make_logical("logical_or")
logical_xor = _make_logical("logical_xor")
logical_not = _make_logical("logical_not", binary=False)

__all__ = _UNARY_OPS + ["clip", "clip_by_norm", "logical_and", "logical_or",
                        "logical_xor", "logical_not"]
