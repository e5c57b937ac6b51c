"""Neural-network layer functions (counterpart of
paddle_tpu/fluid/layers/nn.py), those ResNet training, the text
classifiers, the CTC acoustic model and the word2vec N-gram model build:
fc (over one input or several), embedding, softmax, cross_entropy,
softmax_with_cross_entropy, mean, conv2d, pool2d, batch_norm, topk,
warpctc, ctc_greedy_decoder and edit_distance; the elementwise
add, sub, mul, div, max, min and pow that the schedules and the clips
build; those the decoder LM of the generation slice builds:
layer_norm and causal_self_attention; and those the book chapters build:
dropout, square_error_cost, sigmoid_cross_entropy_with_logits, accuracy,
mul, linear_chain_crf, crf_decoding, cos_sim, matmul, l2_normalize,
multiplex, one_hot and smooth_l1; and those the legacy layer DSL
(v2/config_helpers.py) builds: lrn, maxout, im2sequence, rank_loss, nce,
pad and crop; and the conv family and the rest of the breadth layers:
conv2d_transpose, conv3d, conv3d_transpose, pool3d, max_pool2d_with_index,
max_pool3d_with_index, unpool, spp, norm, prelu, cumsum, expand,
label_smooth, margin_rank_loss, bilinear_tensor_product and is_empty.
Each appends the same ops, with the same attrs and names, as its reference
counterpart."""

from __future__ import annotations

import numpy as np

from ..framework import Variable
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


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    """Paddle's 2018 dropout (reference nn.py:71): Out = X * Mask in
    training, X * (1 - p) under ``is_test``; Mask is an output too."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    mask = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                      lod_level=x.lod_level,
                                      stop_gradient=True)
    helper.append_op("dropout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed or 0})
    return out


def square_error_cost(input, label):
    """(input - label)² as an elementwise_sub and a square op (reference
    nn.py:119)."""
    helper = LayerHelper("square_error_cost")
    minus_out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("elementwise_sub",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [minus_out.name]})
    sq = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("square", inputs={"X": [minus_out.name]},
                     outputs={"Out": [sq.name]})
    return sq


def sigmoid_cross_entropy_with_logits(x, label):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits")
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Out": [out.name]})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of a batch (reference nn.py:150): a top_k op, then
    an accuracy op with its int32 Correct and Total counts."""
    helper = LayerHelper("accuracy")
    topk_shape = tuple(input.shape[:-1]) + (k,)
    topk_out = helper.create_tmp_variable(input.dtype, shape=topk_shape,
                                          stop_gradient=True)
    topk_indices = helper.create_tmp_variable("int64", shape=topk_shape,
                                              stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input.name]},
                     outputs={"Out": [topk_out.name],
                              "Indices": [topk_indices.name]},
                     attrs={"k": k})
    acc_out = helper.create_tmp_variable("float32", shape=(),
                                         stop_gradient=True)
    correct = correct or helper.create_tmp_variable("int32", shape=(),
                                                    stop_gradient=True)
    total = total or helper.create_tmp_variable("int32", shape=(),
                                                stop_gradient=True)
    helper.append_op("accuracy",
                     inputs={"Out": [topk_out.name],
                             "Indices": [topk_indices.name],
                             "Label": [label.name]},
                     outputs={"Accuracy": [acc_out.name],
                              "Correct": [correct.name],
                              "Total": [total.name]})
    return acc_out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """The flatten-to-2D product (reference nn.py:262)."""
    helper = LayerHelper("mul")
    out = helper.create_tmp_variable(
        x.dtype, shape=tuple(x.shape[:x_num_col_dims])
        + tuple(y.shape[y_num_col_dims:]))
    helper.append_op("mul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """Batched X @ Y with transpose flags (reference nn.py:541)."""
    helper = LayerHelper("matmul", name=name)
    xs, ys = list(x.shape), list(y.shape)
    if transpose_x:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    out = helper.create_tmp_variable(x.dtype, shape=tuple(xs[:-1] + ys[-1:]))
    helper.append_op("matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y})
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity [N, 1] (reference nn.py:531); the op also
    keeps both rows' norms for its grad, as cos_sim_op.cc does."""
    helper = LayerHelper("cos_sim")
    out = helper.create_tmp_variable(X.dtype, shape=tuple(X.shape[:-1]) + (1,))
    xnorm = helper.create_tmp_variable(X.dtype, stop_gradient=True)
    ynorm = helper.create_tmp_variable(X.dtype, stop_gradient=True)
    helper.append_op("cos_sim", inputs={"X": [X.name], "Y": [Y.name]},
                     outputs={"Out": [out.name], "XNorm": [xnorm.name],
                              "YNorm": [ynorm.name]})
    return out


def linear_chain_crf(input, label, param_attr=None):
    """The CRF's negative log-likelihood [b, 1] (reference nn.py:452) over
    a [num_tags + 2, num_tags] Transition parameter."""
    helper = LayerHelper("linear_chain_crf")
    size = input.shape[-1]
    transition = helper.create_parameter(param_attr, shape=(size + 2, size),
                                         dtype=input.dtype)
    log_likelihood = helper.create_tmp_variable(input.dtype)
    helper.append_op("linear_chain_crf",
                     inputs={"Emission": [input.name],
                             "Transition": [transition.name],
                             "Label": [label.name]},
                     outputs={"LogLikelihood": [log_likelihood.name]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """Viterbi paths (reference nn.py:469) over the Transition parameter
    that ``param_attr`` names (the CRF's, shared by name)."""
    helper = LayerHelper("crf_decoding")
    transition = helper.create_parameter(
        ParamAttr.to_attr(param_attr),
        shape=(input.shape[-1] + 2, input.shape[-1]), dtype=input.dtype)
    path = helper.create_tmp_variable("int64", lod_level=1)
    inputs = {"Emission": [input.name], "Transition": [transition.name]}
    if label is not None:
        inputs["Label"] = [label.name]
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path.name]})
    return path


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / sqrt(max(Σ x² along ``axis``, epsilon)) as square, reduce_sum,
    clip, sqrt, reciprocal and elementwise_mul ops (reference
    nn.py:787)."""
    helper = LayerHelper("l2_normalize", name=name)
    if len(x.shape) == 1:
        axis = 0
    rshape = tuple(1 if i == axis % len(x.shape) else s
                   for i, s in enumerate(x.shape))

    def unary(op_type, src, shape, attrs=None):
        out = helper.create_tmp_variable(x.dtype, shape=shape)
        helper.append_op(op_type, inputs={"X": [src.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out

    square = unary("square", x, x.shape)
    reduced = unary("reduce_sum", square, rshape,
                    {"dim": axis, "keep_dim": True, "reduce_all": False})
    clipped = unary("clip", reduced, rshape,
                    {"min": float(epsilon), "max": 3.4e38})
    rsq = unary("reciprocal", unary("sqrt", clipped, rshape), rshape)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("elementwise_mul",
                     inputs={"X": [x.name], "Y": [rsq.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": -1})
    return out


def multiplex(inputs, index):
    """Row i from candidate ``inputs[index[i]]`` (reference nn.py:821)."""
    if not isinstance(inputs, (list, tuple)) or len(inputs) < 2:
        raise ValueError("multiplex needs at least 2 input tensors")
    helper = LayerHelper("multiplex")
    out = helper.create_tmp_variable(inputs[0].dtype, shape=inputs[0].shape)
    helper.append_op("multiplex",
                     inputs={"X": [i.name for i in inputs],
                             "Ids": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def one_hot(input, depth):
    """Int ids as float32 one-hot rows (reference nn.py:835)."""
    helper = LayerHelper("one_hot")
    shape = tuple(input.shape[:-1]) + (depth,) if input.shape else None
    out = helper.create_tmp_variable("float32", shape=shape)
    helper.append_op("one_hot", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"depth": depth})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """Smooth-L1 loss rows [N, 1] (reference nn.py:845)."""
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_tmp_variable(x.dtype, shape=x.shape)
    loss = helper.create_tmp_variable(x.dtype, shape=(x.shape[0], 1))
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff.name], "Out": [loss.name]},
                     attrs={"sigma": 1.0 if sigma is None else float(sigma)})
    return loss


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


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Cross-channel local response normalization (reference nn.py:441)."""
    helper = LayerHelper("lrn", name=name)
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    mid = helper.create_tmp_variable(input.dtype, shape=input.shape,
                                     stop_gradient=True)
    helper.append_op("lrn", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "MidOut": [mid.name]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def maxout(x, groups, name=None):
    """The max over each group of ``groups`` channels (reference
    nn.py:585)."""
    helper = LayerHelper("maxout", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("maxout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"groups": groups})
    return out


def im2sequence(input, filter_size, stride=1, padding=0, name=None):
    """Each image as a sequence of its flattened patches (reference
    nn.py:642); the output's rows are [-1, c * kh * kw]."""
    helper = LayerHelper("im2sequence", name=name)
    ks = [filter_size, filter_size] if isinstance(filter_size, int) \
        else list(filter_size)
    st = [stride, stride] if isinstance(stride, int) else list(stride)
    pd = [padding] * 4 if isinstance(padding, int) else list(padding)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    shape = None
    if input.shape is not None:
        shape = (-1, input.shape[1] * ks[0] * ks[1])
    out = helper.create_tmp_variable(input.dtype, shape=shape, lod_level=1)
    helper.append_op("im2sequence", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"kernels": ks, "strides": st, "paddings": pd})
    return out


def rank_loss(label, left, right, name=None):
    """RankNet's pairwise loss (reference nn.py:661)."""
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_tmp_variable(left.dtype, shape=left.shape)
    helper.append_op("rank_loss",
                     inputs={"Label": [label.name], "Left": [left.name],
                             "Right": [right.name]},
                     outputs={"Out": [out.name]})
    return out


def nce(input, label, num_total_classes, num_neg_samples=10,
        sample_weight=None, param_attr=None, bias_attr=None,
        custom_neg_classes=None, name=None):
    """Noise-contrastive estimation cost per sample over [true | sampled
    negative] classes (reference nn.py:709)."""
    helper = LayerHelper("nce", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(ParamAttr.to_attr(param_attr),
                                shape=(num_total_classes, dim),
                                dtype=input.dtype,
                                default_initializer=Xavier())
    b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                shape=(num_total_classes,),
                                dtype=input.dtype,
                                default_initializer=Constant(0.0))
    cost = helper.create_tmp_variable(input.dtype)
    sample_labels = helper.create_tmp_variable("int32", stop_gradient=True)
    inputs = {"Input": [input.name], "Label": [label.name],
              "Weight": [w.name], "Bias": [b.name]}
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight.name]
    helper.append_op(
        "nce", inputs=inputs,
        outputs={"Cost": [cost.name],
                 "SampleLabels": [sample_labels.name]},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples,
               "custom_neg_classes": list(custom_neg_classes or [])})
    return cost


def pad(x, paddings, pad_value=0.0, name=None):
    """Widen each dim by its (before, after) pair (reference nn.py:874)."""
    helper = LayerHelper("pad", name=name)
    shape = tuple(int(s + paddings[2 * i] + paddings[2 * i + 1])
                  for i, s in enumerate(x.shape)) if x.shape else None
    out = helper.create_tmp_variable(x.dtype, shape=shape)
    helper.append_op("pad", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """A window of x at ``offsets``, its shape given or borrowed from a
    Variable (reference nn.py:888)."""
    helper = LayerHelper("crop", name=name)
    inputs = {"X": [x.name]}
    attrs = {}
    if isinstance(shape, Variable):
        inputs["Y"] = [shape.name]
        out_shape = shape.shape
    else:
        attrs["shape"] = list(shape)
        out_shape = tuple(shape)
    attrs["offsets"] = list(offsets) if offsets is not None \
        else [0] * len(x.shape)
    out = helper.create_tmp_variable(x.dtype, shape=out_shape)
    helper.append_op("crop", inputs=inputs, outputs={"Out": [out.name]},
                     attrs=attrs)
    return out


__all__ = ["fc", "embedding", "softmax", "cross_entropy",
           "softmax_with_cross_entropy", "mean", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow", "conv2d",
           "pool2d", "batch_norm", "topk", "warpctc", "ctc_greedy_decoder",
           "edit_distance", "layer_norm", "causal_self_attention", "dropout",
           "square_error_cost", "sigmoid_cross_entropy_with_logits",
           "accuracy", "mul", "matmul", "cos_sim", "linear_chain_crf",
           "crf_decoding", "l2_normalize", "multiplex", "one_hot",
           "smooth_l1", "lrn", "maxout", "im2sequence", "rank_loss", "nce",
           "pad", "crop"]


# ---------------------------------------------------------------------------
# the conv family and the rest of the breadth layers (reference nn.py:305,
# :562-785, :862-966)
# ---------------------------------------------------------------------------

def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, use_cudnn=True, act=None, name=None):
    """Transposed conv layer (reference nn.py:305): a conv2d_transpose op,
    the filter [C_in, num_filters, kh, kw] (conv_transpose_op.cc); without
    ``filter_size`` the filter is sized to give ``output_size``."""
    helper = LayerHelper("conv2d_transpose", name=name, act=act,
                         bias_attr=bias_attr)
    c_in = input.shape[1]
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    if filter_size is None:
        h, w_ = input.shape[2], input.shape[3]
        oh, ow = _pair(output_size)
        filter_size = [oh - (h - 1) * stride[0] + 2 * padding[0],
                       ow - (w_ - 1) * stride[1] + 2 * padding[1]]
    fs = _pair(filter_size)
    w = helper.create_parameter(param_attr,
                                shape=(c_in, num_filters, fs[0], fs[1]),
                                dtype=input.dtype)
    pre_bias = helper.create_tmp_variable(input.dtype)
    helper.append_op("conv2d_transpose",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [pre_bias.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation})
    pre_act = _append_channel_bias(helper, pre_bias, num_filters, bias_attr)
    return helper.append_activation(pre_act)


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op("cumsum", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out


def prelu(x, param_attr=None, name=None):
    """Scalar-alpha PReLU (reference prelu_op.cc requires numel(Alpha)==1)."""
    helper = LayerHelper("prelu", name=name)
    alpha = helper.create_parameter(ParamAttr.to_attr(param_attr),
                                    shape=(1,), dtype=x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("prelu", inputs={"X": [x.name], "Alpha": [alpha.name]},
                     outputs={"Out": [out.name]})
    return out


def spp(input, pyramid_height, pool_type="max", name=None):
    helper = LayerHelper("spp", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("spp", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pyramid_height": pyramid_height,
                            "pooling_type": pool_type})
    return out


def max_pool2d_with_index(input, pool_size, pool_stride=None, name=None):
    helper = LayerHelper("max_pool2d_with_index", name=name)
    ks = [pool_size, pool_size] if isinstance(pool_size, int) else pool_size
    st = pool_stride or ks
    st = [st, st] if isinstance(st, int) else st
    out = helper.create_tmp_variable(input.dtype)
    mask = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("max_pool2d_with_index", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"ksize": list(ks), "strides": list(st)})
    return out, mask


def unpool(input, indices, unpooled_size, name=None):
    helper = LayerHelper("unpool", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op("unpool",
                     inputs={"X": [input.name], "Indices": [indices.name]},
                     outputs={"Out": [out.name]},
                     attrs={"unpooled_size": list(unpooled_size)})
    return out


def norm(input, param_attr=None, epsilon=1e-10, name=None):
    """Cross-channel L2 normalization with a learned per-channel scale
    (reference norm_op.h, the SSD conv4_3 normalize layer)."""
    helper = LayerHelper("norm", name=name)
    channels = input.shape[1]
    scale = helper.create_parameter(ParamAttr.to_attr(param_attr),
                                    shape=(channels,), dtype=input.dtype,
                                    default_initializer=Constant(1.0))
    out = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("norm",
                     inputs={"X": [input.name], "Scale": [scale.name]},
                     outputs={"Out": [out.name]},
                     attrs={"epsilon": epsilon})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_tmp_variable(left.dtype, shape=left.shape)
    helper.append_op("margin_rank_loss",
                     inputs={"Label": [label.name], "X1": [left.name],
                             "X2": [right.name]},
                     outputs={"Out": [out.name]}, attrs={"margin": margin})
    return out


def bilinear_tensor_product(x, y, size, param_attr=None, bias_attr=None,
                            name=None):
    helper = LayerHelper("bilinear_tensor_product", name=name,
                         bias_attr=bias_attr)
    w = helper.create_parameter(
        ParamAttr.to_attr(param_attr),
        shape=(size, x.shape[-1], y.shape[-1]), dtype=x.dtype,
        default_initializer=Xavier())
    out = helper.create_tmp_variable(x.dtype, shape=(x.shape[0], size))
    inputs = {"X": [x.name], "Y": [y.name], "Weight": [w.name]}
    if bias_attr is not False:
        b = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                    shape=(size,), dtype=x.dtype,
                                    default_initializer=Constant(0.0))
        inputs["Bias"] = [b.name]
    helper.append_op("bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def is_empty(x, name=None):
    helper = LayerHelper("is_empty", name=name)
    out = helper.create_tmp_variable("bool", shape=(1,), stop_gradient=True)
    helper.append_op("is_empty", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv3d", name=name, act=act, bias_attr=bias_attr)
    ks = [filter_size] * 3 if isinstance(filter_size, int) \
        else list(filter_size)
    c_in = input.shape[1]
    w = helper.create_parameter(
        ParamAttr.to_attr(param_attr),
        shape=(num_filters, c_in // groups, ks[0], ks[1], ks[2]),
        dtype=input.dtype, default_initializer=Xavier())
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "conv3d", inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [out.name]},
        attrs={"strides": [stride] * 3 if isinstance(stride, int)
               else list(stride),
               "paddings": [padding] * 3 if isinstance(padding, int)
               else list(padding),
               "dilations": [dilation] * 3 if isinstance(dilation, int)
               else list(dilation),
               "groups": groups})
    out = _append_channel_bias(helper, out, num_filters, bias_attr)
    return helper.append_activation(out)


def pool3d(input, pool_size=2, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, name=None):
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "pool3d", inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={"ksize": [pool_size] * 3 if isinstance(pool_size, int)
               else list(pool_size),
               "strides": [pool_stride] * 3 if isinstance(pool_stride, int)
               else list(pool_stride),
               "paddings": [pool_padding] * 3
               if isinstance(pool_padding, int) else list(pool_padding),
               "pooling_type": pool_type,
               "global_pooling": global_pooling})
    return out


def expand(x, expand_times, name=None):
    """Tile x by expand_times per dim (reference nn.py:862)."""
    helper = LayerHelper("expand", name=name)
    shape = tuple(int(s * t) for s, t in zip(x.shape, expand_times)) \
        if x.shape else None
    out = helper.create_tmp_variable(x.dtype, shape=shape)
    helper.append_op("expand", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"expand_times": list(expand_times)})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1-eps)*label + eps*prior (reference label_smooth_op.h)."""
    helper = LayerHelper("label_smooth", name=name)
    inputs = {"X": [label.name]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist.name]
    out = helper.create_tmp_variable(label.dtype, shape=label.shape)
    helper.append_op("label_smooth", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"epsilon": float(epsilon)})
    return out


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, act=None, name=None):
    """3-D transposed convolution (reference conv_transpose_op.cc 3-D maker,
    filter layout [C_in, C_out, kd, kh, kw])."""
    helper = LayerHelper("conv3d_transpose", name=name, act=act)
    c_in = input.shape[1]
    st = [stride] * 3 if isinstance(stride, int) else list(stride)
    pd = [padding] * 3 if isinstance(padding, int) else list(padding)
    dl = [dilation] * 3 if isinstance(dilation, int) else list(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size must be set when filter_size is None")
        osize = [output_size] * 3 if isinstance(output_size, int) \
            else list(output_size)
        ks = [osize[i] - (input.shape[2 + i] - 1) * st[i] + 2 * pd[i]
              for i in range(3)]
    else:
        ks = [filter_size] * 3 if isinstance(filter_size, int) \
            else list(filter_size)
    w = helper.create_parameter(
        ParamAttr.to_attr(param_attr),
        shape=(c_in, num_filters, ks[0], ks[1], ks[2]), dtype=input.dtype,
        default_initializer=Xavier())
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "conv3d_transpose",
        inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Output": [out.name]},
        attrs={"strides": st, "paddings": pd, "dilations": dl})
    out = _append_channel_bias(helper, out, num_filters, bias_attr)
    return helper.append_activation(out)


def max_pool3d_with_index(input, pool_size, pool_stride=None, name=None):
    helper = LayerHelper("max_pool3d_with_index", name=name)
    ks = [pool_size] * 3 if isinstance(pool_size, int) else list(pool_size)
    st = pool_stride or ks
    st = [st] * 3 if isinstance(st, int) else list(st)
    out = helper.create_tmp_variable(input.dtype)
    mask = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("max_pool3d_with_index", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"ksize": ks, "strides": st})
    return out, mask

