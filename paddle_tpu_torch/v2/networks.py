"""``paddle.v2.networks`` — the preconfigured-network DSL surface.

Reference: python/paddle/trainer_config_helpers/networks.py (re-exported as
paddle.v2.networks by python/paddle/v2/__init__.py:23). The single-layer
compositions (simple_lstm, img_conv_group, ...) live in
``v2.config_helpers`` where the layer DSL is defined; this module re-exports
them under the reference's module spelling and adds the multi-layer network
builders (sequence_conv_pool, vgg towers, attention).

Everything lowers eagerly to fluid ops — a LayerOutput wraps the lowered
fluid Variable, so these compose freely with ``paddle.layer.*``.
"""

from __future__ import annotations

from .config_helpers import (  # noqa: F401  (re-exported surface)
    LayerOutput, LinearActivation, MaxPooling, TanhActivation,
    _act_str, _fluid_param_attr, _unwrap, bidirectional_gru,
    bidirectional_lstm, fc_layer, grumemory, img_conv_group,
    img_conv_layer, img_pool_layer, lstmemory, batch_norm_layer,
    pooling_layer, simple_gru, simple_img_conv_pool, simple_lstm,
    outputs)

__all__ = [
    "sequence_conv_pool", "text_conv_pool", "simple_lstm", "simple_gru",
    "simple_gru2", "bidirectional_lstm", "bidirectional_gru",
    "simple_img_conv_pool", "img_conv_group", "img_conv_bn_pool",
    "small_vgg", "vgg_16_network", "simple_attention", "outputs",
]


def sequence_conv_pool(input, context_len, hidden_size, name=None,
                       context_start=None, pool_type=None, fc_act=None,
                       fc_param_attr=None, fc_bias_attr=None, **kw):
    """networks.py:40 sequence_conv_pool: context projection (a width-
    ``context_len`` 1-D conv over the ragged sequence) -> fc -> sequence
    pool. The context projection + fc pair IS a sequence_conv with
    ``hidden_size`` filters, which is how it lowers here."""
    import paddle_tpu_torch.fluid as fluid
    x = _unwrap(input, "seq_dense")
    conv = fluid.layers.sequence_conv(
        input=x, num_filters=hidden_size, filter_size=context_len,
        act=_act_str(fc_act) or "tanh", context_start=context_start,
        param_attr=_fluid_param_attr(fc_param_attr),
        bias_attr=_fluid_param_attr(fc_bias_attr))
    pool_type = pool_type or MaxPooling()
    pooled = fluid.layers.sequence_pool(
        input=conv, pool_type=getattr(pool_type, "pool_type", "max"))
    return LayerOutput(pooled, size=hidden_size, name=name)


text_conv_pool = sequence_conv_pool  # networks.py:136


def simple_gru2(input, size, **kw):
    """networks.py simple_gru2 — same capability as simple_gru with the
    mixed-layer fused differently in the reference; one lowering here."""
    return simple_gru(input, size, **kw)


def img_conv_bn_pool(input, filter_size, num_filters, pool_size, name=None,
                     pool_stride=1, act=None, conv_stride=1, conv_padding=0,
                     pool_type=None, num_channel=None, **kw):
    """networks.py img_conv_bn_pool: conv -> batch_norm(act) -> pool."""
    conv = img_conv_layer(input, filter_size=filter_size,
                          num_filters=num_filters, stride=conv_stride,
                          padding=conv_padding, num_channels=num_channel,
                          act=LinearActivation(), name=name)
    bn = batch_norm_layer(conv, act=act)
    return img_pool_layer(bn, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type)


def _vgg_block(tmp, times, channels, dropouts, num_channels=None):
    from .config_helpers import ReluActivation
    return img_conv_group(tmp, conv_num_filter=[channels] * times,
                          num_channels=num_channels,
                          pool_size=2, pool_stride=2,
                          conv_padding=1, conv_filter_size=3,
                          conv_act=ReluActivation(),
                          conv_with_batchnorm=True,
                          conv_batchnorm_drop_rate=dropouts,
                          pool_type=MaxPooling())


def small_vgg(input_image, num_channels, num_classes, name=None):
    """networks.py small_vgg: 4 BN-conv groups (64..512), final pool, then
    dropout -> fc-512 -> BN(relu) -> softmax head."""
    import paddle_tpu_torch.fluid as fluid
    from .config_helpers import (dropout_layer, img_pool_layer,
                                 SoftmaxActivation)
    tmp = _vgg_block(input_image, 2, 64, [0.3, 0.0], num_channels)
    tmp = _vgg_block(tmp, 2, 128, [0.4, 0.0])
    tmp = _vgg_block(tmp, 3, 256, [0.4, 0.4, 0.0])
    tmp = _vgg_block(tmp, 3, 512, [0.4, 0.4, 0.0])
    tmp = img_pool_layer(tmp, pool_size=2, stride=2, pool_type=MaxPooling())
    tmp = dropout_layer(tmp, 0.5)
    tmp = fc_layer(tmp, size=512, act=LinearActivation())
    tmp = dropout_layer(tmp, 0.5)  # reference ExtraAttr(drop_rate=0.5)
    # BN over the 2-D fc output (the op handles [N, C] directly; the DSL's
    # batch_norm_layer wants image metadata)
    bn = fluid.layers.batch_norm(_unwrap(tmp), act="relu")
    tmp = LayerOutput(bn, size=512)
    return fc_layer(tmp, size=num_classes, act=SoftmaxActivation(),
                    name=name)


def vgg_16_network(input_image, num_channels, num_classes=1000):
    """networks.py vgg_16_network: the 5-group VGG-16 tower + fc-4096 head."""
    from .config_helpers import dropout_layer, SoftmaxActivation
    tmp = _vgg_block(input_image, 2, 64, 0.0, num_channels)
    tmp = _vgg_block(tmp, 2, 128, 0.0)
    tmp = _vgg_block(tmp, 3, 256, 0.0)
    tmp = _vgg_block(tmp, 3, 512, 0.0)
    tmp = _vgg_block(tmp, 3, 512, 0.0)
    tmp = fc_layer(tmp, size=4096, act=None)
    tmp = dropout_layer(tmp, 0.5)
    tmp = fc_layer(tmp, size=4096, act=None)
    tmp = dropout_layer(tmp, 0.5)
    return fc_layer(tmp, size=num_classes, act=SoftmaxActivation())


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     weight_act=None, name=None):
    """networks.py:1400 simple_attention (Bahdanau): scores
    v·act(W s + U h_j) softmaxed over the sequence, context = Σ a_j h_j.

    ``encoded_proj`` is the precomputed U h_j (ragged, like
    encoded_sequence); ``decoder_state`` is dense [batch, size]. Lowering:
    fc(decoder_state) -> sequence_expand over the encoded sequence -> add ->
    act -> fc to 1 -> sequence_softmax -> scale rows -> sum sequence_pool."""
    import paddle_tpu_torch.fluid as fluid
    seq = _unwrap(encoded_sequence, "seq_dense")
    proj = _unwrap(encoded_proj, "seq_dense")
    state = _unwrap(decoder_state)
    proj_size = encoded_proj.size

    s_trans = fluid.layers.fc(
        input=state, size=proj_size, act=None, bias_attr=False,
        param_attr=_fluid_param_attr(transform_param_attr))
    s_expanded = fluid.layers.sequence_expand(x=s_trans, y=proj)
    act = _act_str(weight_act) or "tanh"
    combined = getattr(fluid.layers, act)(
        fluid.layers.elementwise_add(s_expanded, proj))
    scores = fluid.layers.fc(
        input=combined, size=1, act=None, bias_attr=False,
        param_attr=_fluid_param_attr(softmax_param_attr))
    weights = fluid.layers.sequence_softmax(scores)
    weighted = fluid.layers.elementwise_mul(seq, weights)
    context = fluid.layers.sequence_pool(input=weighted, pool_type="sum")
    return LayerOutput(context, size=encoded_sequence.size, name=name)
