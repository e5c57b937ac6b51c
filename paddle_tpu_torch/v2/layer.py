"""paddle.v2.layer — the v2-generation layer API (reference
python/paddle/v2/layer.py wrapping trainer_config_helpers with the _layer
suffix dropped and typed data layers).

Same lowering as config_helpers (eager fluid ops); ``data`` takes a
paddle_tpu_torch.v2.data_type InputType and materializes immediately, so v2
scripts compose with fluid vars transparently:

    import paddle_tpu_torch.v2 as paddle
    images = paddle.layer.data("pixel", paddle.data_type.dense_vector(784))
    h = paddle.layer.fc(images, size=128, act=paddle.activation.Relu())
    cost = paddle.layer.classification_cost(input=pred, label=label)
    paddle.v2.SGD(cost=cost, update_equation=paddle.optimizer.Momentum(...))
"""

from __future__ import annotations

from . import config_helpers as _ch
from .config_helpers import LayerOutput


def data(name, type, height=None, width=None):
    """Typed data layer: the InputType picks dtype/lod up front (the
    reference defers to the data provider; config_helpers' untyped
    data_layer keeps that lazy path)."""
    out = LayerOutput(name=name, data_size=type.dim)
    is_seq = bool(type.seq_type) or type.lod_level > 0
    if is_seq and type.dtype == "int64":
        out.materialize("seq_ids")
    elif is_seq:
        out.materialize("seq_dense")
    elif type.dtype == "int64":
        out.materialize("label")
    else:
        out.materialize("dense")
        if height and width:
            out.hwc = (type.dim // (height * width), height, width)
    _ch._DATA_LAYERS.append(out)
    return out


# suffix-less aliases (reference v2/layer.py __convert_to_v2__)
fc = _ch.fc_layer
img_conv = _ch.img_conv_layer
img_pool = _ch.img_pool_layer
img_cmrnorm = _ch.img_cmrnorm_layer
batch_norm = _ch.batch_norm_layer
addto = _ch.addto_layer
concat = _ch.concat_layer
dropout = _ch.dropout_layer
embedding = _ch.embedding_layer
lstmemory = _ch.lstmemory
grumemory = _ch.grumemory
last_seq = _ch.last_seq
first_seq = _ch.first_seq
pooling = _ch.pooling_layer
cross_entropy_cost = _ch.cross_entropy
classification_cost = _ch.classification_cost
regression_cost = _ch.regression_cost

# networks (reference v2/networks.py re-exports)
simple_lstm = _ch.simple_lstm
simple_gru = _ch.simple_gru
img_conv_group = _ch.img_conv_group
bidirectional_gru = _ch.bidirectional_gru
bidirectional_lstm = _ch.bidirectional_lstm
simple_img_conv_pool = _ch.simple_img_conv_pool

# breadth aliases
clip = _ch.clip_layer
scaling = _ch.scaling_layer
slope_intercept = _ch.slope_intercept_layer
power = _ch.power_layer
trans = _ch.trans_layer
interpolation = _ch.interpolation_layer
cos_sim = _ch.cos_sim
maxout = _ch.maxout_layer
pad = _ch.pad_layer
block_expand = _ch.block_expand_layer
expand = _ch.expand_layer
ctc = _ch.ctc_layer
warp_ctc = _ch.warp_ctc_layer
crf = _ch.crf_layer
rank_cost = _ch.rank_cost
huber_regression_cost = _ch.huber_regression_cost
multi_binary_label_cross_entropy_cost = _ch.multi_binary_label_cross_entropy
sum_cost = _ch.sum_cost
mse_cost = _ch.mse_cost

__all__ = ["data", "fc", "img_conv", "img_pool", "img_cmrnorm",
           "batch_norm", "addto", "concat", "dropout", "embedding",
           "lstmemory", "grumemory", "last_seq", "first_seq", "pooling",
           "cross_entropy_cost", "classification_cost", "regression_cost",
           "simple_lstm", "simple_gru", "img_conv_group",
           "bidirectional_gru", "bidirectional_lstm",
           "simple_img_conv_pool", "clip", "scaling", "slope_intercept",
           "power", "trans", "interpolation", "cos_sim", "maxout", "pad",
           "block_expand", "expand", "ctc", "warp_ctc", "crf", "rank_cost",
           "huber_regression_cost",
           "multi_binary_label_cross_entropy_cost", "sum_cost", "mse_cost",
           "LayerOutput"]
