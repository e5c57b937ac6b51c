"""Neural-network layer functions (counterpart of
paddle_tpu/fluid/layers/nn.py), those ResNet training, the text
classifiers, the CTC acoustic model and the word2vec N-gram model build:
fc (over one input or several), embedding, softmax, cross_entropy,
softmax_with_cross_entropy, mean, conv2d, pool2d, batch_norm, topk,
warpctc, ctc_greedy_decoder and edit_distance; the elementwise
add, sub, mul, div, max, min and pow that the schedules and the clips
build; and those the decoder LM of the generation slice builds:
layer_norm and causal_self_attention.
Each appends the same ops, with the same attrs and names, as its reference
counterpart."""

from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..initializer import Constant, Normal, Xavier


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected layer (reference nn.py:20): mul per input, a sum of
    the products when there are several inputs (reference :46), bias,
    activation."""
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
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(
            mul_results[0].dtype, shape=mul_results[0].shape,
            lod_level=mul_results[0].lod_level)
        helper.append_op("sum", inputs={"X": [m.name for m in mul_results]},
                         outputs={"Out": [pre_bias.name]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
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


def _elementwise(op_type, x, y, axis, act):
    helper = LayerHelper(op_type, act=act)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op(op_type, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None):
    return _elementwise("elementwise_add", x, y, axis, act)


def elementwise_sub(x, y, axis=-1, act=None):
    return _elementwise("elementwise_sub", x, y, axis, act)


def elementwise_mul(x, y, axis=-1, act=None):
    return _elementwise("elementwise_mul", x, y, axis, act)


def elementwise_div(x, y, axis=-1, act=None):
    return _elementwise("elementwise_div", x, y, axis, act)


def elementwise_max(x, y, axis=-1, act=None):
    return _elementwise("elementwise_max", x, y, axis, act)


def elementwise_min(x, y, axis=-1, act=None):
    return _elementwise("elementwise_min", x, y, axis, act)


def elementwise_pow(x, y, axis=-1, act=None):
    return _elementwise("elementwise_pow", x, y, axis, act)


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


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """Layer normalization over the dims from ``begin_norm_axis`` on
    (reference nn.py:414), with a learned scale and shift of that many
    elements."""
    helper = LayerHelper("layer_norm", name=name, act=act)
    norm_dim = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(ParamAttr.to_attr(param_attr),
                                    shape=(norm_dim,), dtype=input.dtype,
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                    shape=(norm_dim,), dtype=input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    mean = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    var = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [out.name], "Mean": [mean.name],
                              "Variance": [var.name]},
                     attrs={"begin_norm_axis": begin_norm_axis,
                            "epsilon": epsilon})
    return helper.append_activation(out)


def causal_self_attention(q, k, v, num_heads, name=None):
    """Causal multi-head self-attention over dense [batch, seq, hidden]
    Q/K/V, already projected (reference nn.py:968). One op per transformer
    layer: the site the generation engine (serving/generate) rewrites into
    its prefill and paged-decode ops over the KV arena."""
    if q.shape and q.shape[-1] is not None and q.shape[-1] % num_heads:
        raise ValueError(
            f"hidden size {q.shape[-1]} must divide num_heads {num_heads}")
    helper = LayerHelper("causal_self_attention", name=name)
    out = helper.create_tmp_variable(q.dtype, shape=q.shape)
    helper.append_op("causal_self_attention",
                     inputs={"Q": [q.name], "K": [k.name], "V": [v.name]},
                     outputs={"Out": [out.name]},
                     attrs={"num_heads": int(num_heads)})
    return out


def topk(input, k):
    """The k largest values of the last axis and their int64 indices
    (reference nn.py:484)."""
    helper = LayerHelper("top_k")
    values = helper.create_tmp_variable(input.dtype,
                                        shape=tuple(input.shape[:-1]) + (k,))
    indices = helper.create_tmp_variable(
        "int64", shape=tuple(input.shape[:-1]) + (k,))
    helper.append_op("top_k", inputs={"X": [input.name]},
                     outputs={"Out": [values.name],
                              "Indices": [indices.name]},
                     attrs={"k": k})
    return values, indices


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss [b, 1] over ragged logits and labels (reference nn.py
    warpctc)."""
    helper = LayerHelper("warpctc")
    loss = helper.create_tmp_variable(input.dtype)
    helper.append_op("warpctc",
                     inputs={"Logits": [input.name], "Label": [label.name]},
                     outputs={"Loss": [loss.name]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank):
    """Arg-max per step, then merge repeats and drop blanks (reference
    nn.py ctc_greedy_decoder: top_k + ctc_align)."""
    helper = LayerHelper("ctc_greedy_decoder")
    _, indices = topk(input, k=1)
    out = helper.create_tmp_variable("int64", lod_level=1)
    helper.append_op("ctc_align", inputs={"Input": [indices.name]},
                     outputs={"Output": [out.name]},
                     attrs={"blank": blank, "merge_repeated": True})
    return out


def edit_distance(input, label, normalized=False, ignored_tokens=None):
    """Levenshtein distance of each decoded sequence to its label
    (reference nn.py:508); ``ignored_tokens`` are erased from both first
    (``sequence_erase``). Returns (distances [b, 1], the sequence
    count)."""
    helper = LayerHelper("edit_distance")
    if ignored_tokens:
        erased = helper.create_tmp_variable(input.dtype, lod_level=1)
        helper.append_op("sequence_erase", inputs={"X": [input.name]},
                         outputs={"Out": [erased.name]},
                         attrs={"tokens": list(ignored_tokens)})
        input = erased
        erased_l = helper.create_tmp_variable(label.dtype, lod_level=1)
        helper.append_op("sequence_erase", inputs={"X": [label.name]},
                         outputs={"Out": [erased_l.name]},
                         attrs={"tokens": list(ignored_tokens)})
        label = erased_l
    out = helper.create_tmp_variable("float32")
    seq_num = helper.create_tmp_variable("int64")
    helper.append_op("edit_distance",
                     inputs={"Hyps": [input.name], "Refs": [label.name]},
                     outputs={"Out": [out.name],
                              "SequenceNum": [seq_num.name]},
                     attrs={"normalized": normalized})
    return out, seq_num


__all__ = ["fc", "embedding", "softmax", "cross_entropy",
           "softmax_with_cross_entropy", "mean", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow", "conv2d",
           "pool2d", "batch_norm", "topk", "warpctc", "ctc_greedy_decoder",
           "edit_distance", "layer_norm", "causal_self_attention"]
