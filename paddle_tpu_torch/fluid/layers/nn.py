"""Neural-network layer functions (counterpart of
paddle_tpu/fluid/layers/nn.py), those ResNet training and the LSTM text
classifier build: fc, embedding, softmax, cross_entropy,
softmax_with_cross_entropy, mean, elementwise_add, conv2d, pool2d and
batch_norm. Each appends the same ops, with the same attrs and names, as its
reference counterpart."""

from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..initializer import Constant, Normal, Xavier


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected layer (reference nn.py:20): mul per input + sum +
    bias + activation."""
    helper = LayerHelper("fc", name=name, act=act, bias_attr=bias_attr)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_shape = inp.shape
        flat_dim = int(np.prod(in_shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, shape=(flat_dim, size),
                                    dtype=inp.dtype)
        out = helper.create_tmp_variable(
            inp.dtype, shape=tuple(in_shape[:num_flatten_dims]) + (size,),
            lod_level=inp.lod_level)
        helper.append_op("mul", inputs={"X": [inp.name], "Y": [w.name]},
                         outputs={"Out": [out.name]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) != 1:
        raise NotImplementedError(
            "fc over several inputs needs the sum op, which is not ported")
    pre_act = helper.append_bias_op(mul_results[0],
                                    dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """Embedding lookup (reference nn.py:52): a lookup_table op over a
    [vocab, dim] parameter; the output keeps the ids' LoD."""
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, shape=tuple(size), dtype=dtype,
                                default_initializer=Xavier())
    out_shape = None
    if input.shape is not None:
        out_shape = tuple(input.shape[:-1] or input.shape) + (size[1],)
    out = helper.create_tmp_variable(dtype, shape=out_shape,
                                     lod_level=input.lod_level)
    helper.append_op("lookup_table",
                     inputs={"W": [w.name], "Ids": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"is_sparse": is_sparse,
                            "padding_idx": padding_idx})
    return out


def cross_entropy(input, label, soft_label=False):
    """Per-row loss −log p[label] of shape [N, 1] on probabilities
    (reference nn.py:94)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_tmp_variable(
        input.dtype, shape=tuple(input.shape[:-1]) + (1,))
    helper.append_op("cross_entropy",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]},
                     attrs={"soft_label": soft_label})
    return out


def softmax(input, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    helper.append_op("softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    """Per-row loss of shape [N, 1] (reference nn.py:106)."""
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_tmp_variable(logits.dtype, shape=logits.shape)
    loss = helper.create_tmp_variable(
        logits.dtype, shape=tuple(logits.shape[:-1]) + (1,))
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name], "Label": [label.name]},
                     outputs={"Softmax": [softmax_out.name],
                              "Loss": [loss.name]},
                     attrs={"soft_label": soft_label})
    return loss


def mean(x, name=None):
    """Mean over all elements, a scalar (reference nn.py:142)."""
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=())
    helper.append_op("mean", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def elementwise_add(x, y, axis=-1, act=None):
    helper = LayerHelper("elementwise_add", act=act)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op("elementwise_add", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return helper.append_activation(out)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [int(v), int(v)]


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """Conv layer (reference nn.py:277). The filter is OIHW in both
    layouts; ``use_cudnn`` is accepted for source compatibility."""
    helper = LayerHelper("conv2d", name=name, act=act, bias_attr=bias_attr)
    c_in = input.shape[-1] if data_format == "NHWC" else input.shape[1]
    groups = groups or 1
    fs = _pair(filter_size)
    w = helper.create_parameter(
        param_attr, shape=(num_filters, c_in // groups, fs[0], fs[1]),
        dtype=input.dtype,
        default_initializer=Normal(0.0, (2.0 / (fs[0] * fs[1] * c_in)) ** 0.5))
    attrs = {"strides": _pair(stride), "paddings": _pair(padding),
             "dilations": _pair(dilation), "groups": groups,
             "data_format": data_format}
    pre_bias = helper.create_tmp_variable(input.dtype)
    helper.append_op("conv2d",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [pre_bias.name]}, attrs=attrs)
    pre_act = _append_channel_bias(helper, pre_bias, num_filters, bias_attr,
                                   data_format)
    return helper.append_activation(pre_act)


def _append_channel_bias(helper, pre_bias, num_channels, bias_attr,
                         data_format="NCHW"):
    """Per-output-channel bias along the channel dim (last under NHWC)."""
    if bias_attr is False:
        return pre_bias
    axis = -1 if data_format == "NHWC" else 1
    b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                shape=(num_channels,),
                                dtype=pre_bias.dtype, is_bias=True)
    out = helper.create_tmp_variable(pre_bias.dtype, shape=pre_bias.shape)
    helper.append_op("elementwise_add",
                     inputs={"X": [pre_bias.name], "Y": [b.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None,
           data_format="NCHW"):
    """Pooling layer (reference nn.py:352)."""
    if pool_type not in ("max", "avg"):
        raise ValueError(f"pool_type must be max|avg, got {pool_type!r}")
    if not global_pooling and (pool_size == -1 or pool_size is None):
        raise ValueError(
            "pool_size must be set when global_pooling is False")
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("pool2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode,
                            "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None):
    """Batch norm layer (reference nn.py:374). Running mean/variance are
    non-trainable parameters, so they are saved with the model."""
    helper = LayerHelper("batch_norm", name=name, act=act)
    c = input.shape[-1] if data_layout == "NHWC" else input.shape[1]

    scale = helper.create_parameter(ParamAttr.to_attr(param_attr), shape=(c,),
                                    dtype=input.dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr), shape=(c,),
                                   dtype=input.dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False), shape=(c,),
        dtype=input.dtype, default_initializer=Constant(0.0))
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False), shape=(c,),
        dtype=input.dtype, default_initializer=Constant(1.0))

    saved_mean = helper.create_tmp_variable(input.dtype, shape=(c,),
                                            stop_gradient=True)
    saved_var = helper.create_tmp_variable(input.dtype, shape=(c,),
                                           stop_gradient=True)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("batch_norm",
                     inputs={"X": [input.name], "Scale": [scale.name],
                             "Bias": [bias.name], "Mean": [mean.name],
                             "Variance": [variance.name]},
                     outputs={"Y": [out.name], "MeanOut": [mean.name],
                              "VarianceOut": [variance.name],
                              "SavedMean": [saved_mean.name],
                              "SavedVariance": [saved_var.name]},
                     attrs={"momentum": momentum, "epsilon": epsilon,
                            "is_test": is_test, "data_layout": data_layout})
    return helper.append_activation(out)


__all__ = ["fc", "embedding", "softmax", "cross_entropy",
           "softmax_with_cross_entropy", "mean", "elementwise_add", "conv2d",
           "pool2d", "batch_norm"]
