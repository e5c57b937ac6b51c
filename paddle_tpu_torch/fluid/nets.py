"""Composite networks (counterpart of paddle_tpu/fluid/nets.py):
``simple_img_conv_pool`` (reference :14), ``img_conv_group`` (:24),
``sequence_conv_pool`` (:61), ``glu`` (:69) and
``scaled_dot_product_attention`` (:75). Each composes layers only, with
the reference's signature, so a program built here names and orders its
ops as the reference's does."""

from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, pool_type="max", param_attr=None,
                         bias_attr=None):
    """conv2d with ``act``, then pool2d."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max"):
    """A VGG block: per entry of ``conv_num_filter`` a conv2d (its act
    moved after the batch_norm where there is one, then dropout at that
    entry's rate), then one pool2d. Scalar arguments apply to every
    conv."""
    assert isinstance(conv_num_filter, (list, tuple))

    def per_conv(v):
        return list(v) if hasattr(v, "__len__") \
            else [v] * len(conv_num_filter)

    conv_padding = per_conv(conv_padding)
    conv_filter_size = per_conv(conv_filter_size)
    param_attr = per_conv(param_attr)
    conv_with_batchnorm = per_conv(conv_with_batchnorm)
    conv_batchnorm_drop_rate = per_conv(conv_batchnorm_drop_rate)
    tmp = input
    for i, num_filters in enumerate(conv_num_filter):
        tmp = layers.conv2d(
            input=tmp, num_filters=num_filters,
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i],
            act=None if conv_with_batchnorm[i] else conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if abs(conv_batchnorm_drop_rate[i]) > 1e-5:
                tmp = layers.dropout(x=tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv with ``act``, then sequence_pool."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """The gated linear unit: ``input`` split in two along ``dim``, a ·
    sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head attention over [batch, len, hidden] inputs: hidden split
    into ``num_heads`` heads, softmax(q·kᵀ / √d)·v per head, the heads
    joined back; dropout on the weights at ``dropout_rate``."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    if queries.shape[-1] % num_heads:
        raise ValueError("hidden size must divide num_heads")

    def split_heads(x):
        if num_heads == 1:
            return x
        b, n, h = x.shape
        r = layers.reshape(x, [b, n, num_heads, h // num_heads])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        b, heads, n, d = x.shape
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(t, [b, n, heads * d])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    scaled_q = layers.scale(q, scale=q.shape[-1] ** -0.5)
    weights = layers.softmax(layers.matmul(scaled_q, k, transpose_y=True))
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    return combine_heads(layers.matmul(weights, v))
