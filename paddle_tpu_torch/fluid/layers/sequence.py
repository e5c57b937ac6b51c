"""Sequence and recurrent layer functions (counterpart of
paddle_tpu/fluid/layers/sequence.py): ``dynamic_lstm`` (reference :16),
``dynamic_gru`` (reference :46), ``sequence_pool`` and
``sequence_last_step`` (reference :107). The ops run over padded
LoDArrays (``ops/rnn_ops.py``, ``ops/sequence_ops.py``). The other
sequence layers wait for a later slice."""

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


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_tmp_variable(input.dtype, lod_level=0)
    helper.append_op("sequence_pool", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_last_step(input):
    return sequence_pool(input, "last")


__all__ = ["dynamic_lstm", "dynamic_gru", "sequence_pool",
           "sequence_last_step"]
