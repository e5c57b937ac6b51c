"""The models the port's slices run, with their widths as parameters so
tests can build a narrow net and chip_smoke.py the published one:

* ``resnet``: ResNet in NHWC, as bench.py:175-214 builds ResNet-50
  (``counts=(3, 4, 6, 3)``, ``base=64``);
* ``lstm_textcls``: the LSTM text classifier of bench.py:239
  (vocab 30000, emb 128, hidden 512, 2 LSTM layers, 2 classes).

``layers`` is the fluid.layers namespace to build with: this package's by
default. Any module with the same layer API builds the same program, which
is how the tests build the reference package's twin of a port program.
"""

from __future__ import annotations


def _conv_bn_layer(layers, input, num_filters, filter_size, stride=1,
                   act="relu"):
    conv = layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=1, act=None,
                         bias_attr=False, data_format="NHWC")
    return layers.batch_norm(input=conv, act=act, data_layout="NHWC")


def _bottleneck_block(layers, input, num_filters, stride):
    conv0 = _conv_bn_layer(layers, input, num_filters, 1)
    conv1 = _conv_bn_layer(layers, conv0, num_filters, 3, stride=stride)
    conv2 = _conv_bn_layer(layers, conv1, num_filters * 4, 1, act=None)
    if input.shape[-1] != num_filters * 4 or stride != 1:
        short = _conv_bn_layer(layers, input, num_filters * 4, 1,
                               stride=stride, act=None)
    else:
        short = input
    return layers.elementwise_add(x=conv2, y=short, act="relu")


def resnet(img, class_dim, counts=(3, 4, 6, 3), base=64, layers=None):
    """Bottleneck ResNet over an NHWC image var; returns the logits var.
    ``counts=(3, 4, 6, 3), base=64`` is ResNet-50."""
    if layers is None:
        from ..fluid import layers
    conv = _conv_bn_layer(layers, img, base, 7, stride=2)
    pool = layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                         pool_padding=1, pool_type="max", data_format="NHWC")
    for stage, count in enumerate(counts):
        for i in range(count):
            stride = 2 if (stage > 0 and i == 0) else 1
            pool = _bottleneck_block(layers, pool, base * 2 ** stage, stride)
    pool = layers.pool2d(input=pool, pool_size=7, pool_type="avg",
                         global_pooling=True, data_format="NHWC")
    return layers.fc(input=pool, size=class_dim, act=None)


def lstm_textcls(words, class_dim=2, vocab=30000, emb=128, hidden=512,
                 lstm_num=2, layers=None):
    """bench.py:239 build_lstm_textcls's network over an int64 ``words``
    sequence (lod_level 1): embedding(vocab, emb), then ``lstm_num`` x
    (fc of width 4·hidden + dynamic_lstm), the last step of each sequence,
    and an fc with softmax over ``class_dim`` classes. Returns the
    probabilities var."""
    if layers is None:
        from ..fluid import layers
    net = layers.embedding(words, size=(vocab, emb))
    for _ in range(lstm_num):
        proj = layers.fc(net, hidden * 4)
        net, _ = layers.dynamic_lstm(proj, size=hidden * 4)
    last = layers.sequence_last_step(net)
    return layers.fc(last, class_dim, act="softmax")
