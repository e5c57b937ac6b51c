"""Generated layer wrappers of single-input ops (counterpart of
paddle_tpu/fluid/layers/ops.py): one layer per unary op of the reference's
``_UNARY_OPS`` (:14-20), extra keyword arguments passed as the op's
attributes; ``clip`` and ``clip_by_norm`` (:78-96) and the logical ops
(:97-117); the ``reduce_*`` layers (:22, :40); ``uniform_random`` (:119),
``gaussian_random`` (:130) and ``scatter`` (:162)."""

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


_REDUCE_OPS = ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
               "reduce_prod"]


def _make_reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        """Reduce over ``dim`` (an int or a list; every dim when None)."""
        helper = LayerHelper(op_type, name=name)
        reduce_all = dim is None
        dims = [0] if dim is None else (
            [dim] if isinstance(dim, int) else list(dim))
        out_shape = None
        if input.shape is not None:
            nd = len(input.shape)
            axes = set(range(nd)) if reduce_all else {d % nd for d in dims}
            out_shape = tuple(1 if i in axes else s
                              for i, s in enumerate(input.shape)
                              if keep_dim or i not in axes)
        out = helper.create_tmp_variable(input.dtype, shape=out_shape)
        helper.append_op(op_type, inputs={"X": [input.name]},
                         outputs={"Out": [out.name]},
                         attrs={"dim": dims if len(dims) > 1 else dims[0],
                                "keep_dim": keep_dim,
                                "reduce_all": reduce_all})
        return out
    layer.__name__ = op_type
    return layer


_mod = sys.modules[__name__]
for _t in _UNARY_OPS:
    setattr(_mod, _t, _make_unary(_t))
for _t in _REDUCE_OPS:
    setattr(_mod, _t, _make_reduce(_t))


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



def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_tmp_variable(dtype, shape=tuple(shape),
                                     stop_gradient=True)
    helper.append_op("uniform_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "min": float(min), "max": float(max),
                            "seed": int(seed)})
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_tmp_variable(dtype, shape=tuple(shape),
                                     stop_gradient=True)
    helper.append_op("gaussian_random", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "mean": float(mean), "std": float(std),
                            "seed": int(seed)})
    return out


def _make_random_batch_size_like(op_type):
    def layer(input, shape, dtype="float32", input_dim_idx=0,
              output_dim_idx=0, **attrs):
        helper = LayerHelper(op_type)
        out = helper.create_tmp_variable(dtype, stop_gradient=True)
        helper.append_op(op_type, inputs={"Input": [input.name]},
                         outputs={"Out": [out.name]},
                         attrs={"shape": list(shape), "dtype": dtype,
                                "input_dim_idx": input_dim_idx,
                                "output_dim_idx": output_dim_idx, **attrs})
        return out
    layer.__name__ = op_type
    return layer


uniform_random_batch_size_like = _make_random_batch_size_like(
    "uniform_random_batch_size_like")
gaussian_random_batch_size_like = _make_random_batch_size_like(
    "gaussian_random_batch_size_like")


def scatter(input, index, updates, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("scatter",
                     inputs={"X": [input.name], "Ids": [index.name],
                             "Updates": [updates.name]},
                     outputs={"Out": [out.name]})
    return out


__all__ = _UNARY_OPS + _REDUCE_OPS + [
    "clip", "clip_by_norm", "logical_and", "logical_or", "logical_xor",
    "logical_not", "uniform_random", "gaussian_random",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "scatter"]
