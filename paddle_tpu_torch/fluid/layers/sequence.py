"""Sequence and recurrent layer functions (counterpart of
paddle_tpu/fluid/layers/sequence.py): ``dynamic_lstm`` (reference :16),
``sequence_pool`` and ``sequence_last_step`` (reference :107). The ops
run over padded LoDArrays (``ops/rnn_ops.py``, ``ops/sequence_ops.py``).
dynamic_gru and the other sequence layers wait for a later slice."""

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


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_tmp_variable(input.dtype, lod_level=0)
    helper.append_op("sequence_pool", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_last_step(input):
    return sequence_pool(input, "last")


__all__ = ["dynamic_lstm", "sequence_pool", "sequence_last_step"]
