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
multiplex, one_hot and smooth_l1.
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


__all__ = ["fc", "embedding", "softmax", "cross_entropy",
           "softmax_with_cross_entropy", "mean", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow", "conv2d",
           "pool2d", "batch_norm", "topk", "warpctc", "ctc_greedy_decoder",
           "edit_distance", "layer_norm", "causal_self_attention", "dropout",
           "square_error_cost", "sigmoid_cross_entropy_with_logits",
           "accuracy", "mul", "matmul", "cos_sim", "linear_chain_crf",
           "crf_decoding", "l2_normalize", "multiplex", "one_hot",
           "smooth_l1"]
