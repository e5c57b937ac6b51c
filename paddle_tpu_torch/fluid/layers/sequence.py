"""Sequence and recurrent layer functions (counterpart of
paddle_tpu/fluid/layers/sequence.py, all of it): ``dynamic_lstm``
(reference :16), ``dynamic_gru`` (:46), ``sequence_conv`` (:69),
``sequence_pool`` with ``sequence_first_step`` / ``sequence_last_step``
(:95), ``sequence_softmax``, ``sequence_expand``, ``sequence_reshape``,
``sequence_concat``, ``sequence_slice``, ``lod_reset``, ``row_conv``, the
single steps ``lstm_unit`` and ``gru_unit``, ``dynamic_lstmp`` and
``dynamic_vanilla_rnn`` (:183-303). The ops run over padded LoDArrays
(``ops/rnn_ops.py``, ``ops/sequence_ops.py``)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """``input`` is the projected gate pre-activation [*, 4·hidden] (an fc
    of width 4·hidden first, as in the reference); ``size`` = 4·hidden.
    Returns (hidden, cell), both with the input's LoD."""
    helper = LayerHelper("lstm", name=name)
    hidden = size // 4
    weight = helper.create_parameter(param_attr, shape=(hidden, 4 * hidden),
                                     dtype=dtype)
    # with peepholes the bias carries the diagonal cell->gate weights too:
    # [4H gate bias | W_ic | W_fc | W_oc]
    bias_width = 7 * hidden if use_peepholes else 4 * hidden
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                   shape=(1, bias_width), dtype=dtype,
                                   is_bias=True)
    hidden_out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    cell_out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    helper.append_op(
        "lstm",
        inputs={"Input": [input.name], "Weight": [weight.name],
                "Bias": [bias.name]},
        outputs={"Hidden": [hidden_out.name], "Cell": [cell_out.name]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden_out, cell_out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    """``input`` is the projected pre-activation [*, 3·size] (an fc of
    width 3·size first, as in the reference); ``size`` is the hidden width.
    Returns the hidden sequence, with the input's LoD."""
    helper = LayerHelper("gru")
    weight = helper.create_parameter(param_attr, shape=(size, 3 * size),
                                     dtype=dtype)
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                   shape=(1, 3 * size), dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    helper.append_op(
        "gru", inputs=inputs, outputs={"Hidden": [hidden.name]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  context_start=None):
    """context_start: first row of the context window relative to the
    current step (reference sequence_conv_op.cc contextStart); None centers
    the window, 0 makes it causal/left-aligned."""
    helper = LayerHelper("sequence_conv", act=act, bias_attr=bias_attr)
    filter_shape = (filter_size * input.shape[-1], num_filters)
    filter_param = helper.create_parameter(param_attr, shape=filter_shape,
                                           dtype=input.dtype)
    pre_bias = helper.create_tmp_variable(input.dtype,
                                          lod_level=input.lod_level)
    if context_start is None:
        context_start = -int(filter_size // 2)
    helper.append_op(
        "sequence_conv",
        inputs={"X": [input.name], "Filter": [filter_param.name]},
        outputs={"Out": [pre_bias.name]},
        attrs={"contextStride": filter_stride,
               "contextStart": int(context_start),
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_tmp_variable(input.dtype, lod_level=0)
    helper.append_op("sequence_pool", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_tmp_variable(input.dtype, lod_level=input.lod_level)
    helper.append_op("sequence_softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    """ref_level selects which of y's LoD levels drives the expansion
    (reference layers/nn.py sequence_expand): -1/innermost tiles x rows
    along y's sequences; 0 over a 2-level y repeats x's rows per inner
    sequence."""
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_tmp_variable(x.dtype,
                                     lod_level=0 if ref_level == 0 else 1)
    helper.append_op("sequence_expand",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ref_level": ref_level})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op("sequence_reshape", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"new_dim": new_dim})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_tmp_variable(input[0].dtype, lod_level=1)
    helper.append_op("sequence_concat",
                     inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op("sequence_slice",
                     inputs={"X": [input.name], "Offset": [offset.name],
                             "Length": [length.name]},
                     outputs={"Out": [out.name]})
    return out


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper("lod_reset")
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    inputs = {"X": [x.name]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y.name]
    elif target_lod is not None:
        attrs["target_lod"] = list(target_lod)
    else:
        raise ValueError("lod_reset: provide y or target_lod")
    helper.append_op("lod_reset", inputs=inputs,
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", act=act)
    filter_shape = (future_context_size + 1, input.shape[-1])
    filter_param = helper.create_parameter(param_attr, shape=filter_shape,
                                           dtype=input.dtype)
    out = helper.create_tmp_variable(input.dtype, lod_level=input.lod_level)
    helper.append_op("row_conv",
                     inputs={"X": [input.name],
                             "Filter": [filter_param.name]},
                     outputs={"Out": [out.name]})
    return helper.append_activation(out)


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step from dense inputs (reference nn.py lstm_unit): fc over
    [x_t, h_prev] to 4H gates, then the fused lstm_unit op."""
    from . import nn, tensor
    helper = LayerHelper("lstm_unit", name=name)
    size = cell_t_prev.shape[-1] * 4
    concat_out = tensor.concat([x_t, hidden_t_prev], axis=1)
    fc_out = nn.fc(concat_out, size=size, param_attr=param_attr,
                   bias_attr=bias_attr)
    c = helper.create_tmp_variable(x_t.dtype, shape=cell_t_prev.shape)
    h = helper.create_tmp_variable(x_t.dtype, shape=cell_t_prev.shape)
    helper.append_op("lstm_unit",
                     inputs={"X": [fc_out.name],
                             "C_prev": [cell_t_prev.name]},
                     outputs={"C": [c.name], "H": [h.name]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step: ``input`` is [b, 3*H] projected, ``hidden`` [b, H];
    ``size`` = 3*hidden like the reference gru_unit layer."""
    helper = LayerHelper("gru_unit")
    hidden_dim = size // 3
    weight = helper.create_parameter(param_attr,
                                     shape=(hidden_dim, 3 * hidden_dim),
                                     dtype=input.dtype)
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                   shape=(1, 3 * hidden_dim),
                                   dtype=input.dtype, is_bias=True)
    gate = helper.create_tmp_variable(input.dtype, shape=input.shape)
    reset_hidden_pre = helper.create_tmp_variable(input.dtype,
                                                  shape=hidden.shape)
    updated_hidden = helper.create_tmp_variable(input.dtype,
                                                shape=hidden.shape)
    helper.append_op(
        "gru_unit",
        inputs={"Input": [input.name], "HiddenPrev": [hidden.name],
                "Weight": [weight.name], "Bias": [bias.name]},
        outputs={"Gate": [gate.name],
                 "ResetHiddenPrev": [reset_hidden_pre.name],
                 "Hidden": [updated_hidden.name]},
        attrs={"activation": activation,
               "gate_activation": gate_activation})
    return updated_hidden, reset_hidden_pre, gate


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  proj_activation="tanh", gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  is_reverse=False, name=None):
    """LSTM with recurrent projection (reference layers/nn.py dynamic_lstmp
    -> lstmp_op): the recurrence runs over the proj_size-dim projected
    state. ``input`` carries the [*, 4*H] projected inputs (H = size//4);
    returns (projection LoD var [*, proj_size], cell LoD var [*, H])."""
    helper = LayerHelper("lstmp", name=name)
    H = size // 4
    w = helper.create_parameter(ParamAttr.to_attr(param_attr),
                                shape=(proj_size, size),
                                dtype=input.dtype)
    # the projection weight follows param_attr (initializer/regularizer)
    # but needs its own name — an explicit param_attr name would otherwise
    # alias the recurrent weight (the reference's helper suffixes names)
    proj_attr = ParamAttr.to_attr(param_attr)
    if proj_attr.name is not None:
        import copy
        proj_attr = copy.copy(proj_attr)
        proj_attr.name = proj_attr.name + "_proj"
    proj_w = helper.create_parameter(proj_attr, shape=(H, proj_size),
                                     dtype=input.dtype)
    bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                   shape=(1, size), dtype=input.dtype,
                                   is_bias=True)
    proj = helper.create_tmp_variable(input.dtype, lod_level=1)
    cell = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op(
        "lstmp",
        inputs={"Input": [input.name], "Weight": [w.name],
                "ProjWeight": [proj_w.name], "Bias": [bias.name]},
        outputs={"Projection": [proj.name], "Cell": [cell.name]},
        attrs={"gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation,
               "is_reverse": is_reverse})
    return proj, cell


def dynamic_vanilla_rnn(input, size=None, param_attr=None, bias_attr=None,
                        act="tanh", is_reverse=False, dtype="float32",
                        name=None):
    """Vanilla recurrence h_t = act(x_t + h_{t-1} W + b) over a LoD input
    (the legacy RecurrentLayer the v2 DSL's recurrent_layer maps to; no
    fluid-reference analog — the fluid generation built it from StaticRNN
    blocks)."""
    helper = LayerHelper("simple_rnn", name=name)
    size = size or input.shape[-1]
    weight = helper.create_parameter(param_attr, shape=(size, size),
                                     dtype=dtype)
    inputs = {"Input": [input.name], "Weight": [weight.name]}
    if bias_attr is not False:
        bias = helper.create_parameter(ParamAttr.to_attr(bias_attr),
                                       shape=(1, size), dtype=dtype,
                                       is_bias=True)
        inputs["Bias"] = [bias.name]
    out = helper.create_tmp_variable(dtype, lod_level=input.lod_level)
    helper.append_op(
        "simple_rnn", inputs=inputs,
        outputs={"Out": [out.name]},
        attrs={"activation": act, "is_reverse": is_reverse})
    return out


__all__ = ["dynamic_lstm", "dynamic_gru", "sequence_conv", "sequence_pool",
           "sequence_first_step", "sequence_last_step", "sequence_softmax",
           "sequence_expand", "sequence_reshape", "sequence_concat",
           "sequence_slice", "lod_reset", "row_conv", "lstm_unit",
           "gru_unit", "dynamic_lstmp", "dynamic_vanilla_rnn"]
