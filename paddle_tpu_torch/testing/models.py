"""The models the port's slices run, with their widths as parameters so
tests can build a narrow net and chip_smoke.py the published one:

* ``resnet``: ResNet in NHWC, as bench.py:175-214 builds ResNet-50
  (``counts=(3, 4, 6, 3)``, ``base=64``);
* ``lstm_textcls``: the LSTM text classifier of bench.py:239
  (vocab 30000, emb 128, hidden 512, 2 LSTM layers, 2 classes);
* ``gru_textcls``: its GRU twin, bench.py:320 (the same widths, 2 GRU
  layers);
* ``ctc_acoustic``: the CTC acoustic model of tests/book/test_ocr_ctc.py
  (fc(3H) -> dynamic_gru(H) -> fc(classes + 1) -> warpctc(blank 0) ->
  mean).
* ``ngram_lm``: the word2vec N-gram language model of
  tests/book/test_word2vec.py (context words looking up one shared table
  -> concat -> fc(sigmoid) -> fc(softmax over the vocabulary)).
* ``build_tiny_lm`` / ``export_tiny_lm``: the decoder-only LM the
  generation engine serves (paddle_tpu/testing/models.py:129, :165), with
  the reference's defaults, op order and parameter names.

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


def gru_textcls(words, class_dim=2, vocab=30000, emb=128, hidden=512,
                gru_num=2, layers=None):
    """bench.py:320 build_gru_textcls's network: embedding(vocab, emb),
    then ``gru_num`` x (fc of width 3·hidden + dynamic_gru), the last step
    of each sequence, and an fc with softmax over ``class_dim`` classes.
    Returns the probabilities var."""
    if layers is None:
        from ..fluid import layers
    net = layers.embedding(words, size=(vocab, emb))
    for _ in range(gru_num):
        proj = layers.fc(net, hidden * 3)
        net = layers.dynamic_gru(proj, size=hidden)
    last = layers.sequence_last_step(net)
    return layers.fc(last, class_dim, act="softmax")


def ctc_acoustic(feat, label, num_classes, hidden, layers=None):
    """tests/book/test_ocr_ctc.py:38-50's network over a float ``feat``
    sequence and an int64 ``label`` sequence (both lod_level 1): fc of
    width 3·hidden, dynamic_gru(hidden), an fc to ``num_classes`` + 1
    logits (class 0 is the blank), and the mean CTC loss. Returns
    (logits, loss)."""
    if layers is None:
        from ..fluid import layers
    proj = layers.fc(input=feat, size=hidden * 3, act=None)
    rnn = layers.dynamic_gru(input=proj, size=hidden)
    logits = layers.fc(input=rnn, size=num_classes + 1, act=None)
    loss = layers.mean(layers.warpctc(input=logits, label=label, blank=0))
    return logits, loss


def ngram_lm(words, dict_size, emb=32, hidden=256, is_sparse=True,
             layers=None):
    """tests/book/test_word2vec.py:22-31's network over the int64 context
    word vars ``words`` (each [batch, 1]): every word looks up the one
    table ``shared_w`` [dict_size, emb] (a sparse gradient with
    ``is_sparse``), the embeddings are joined, an fc of width ``hidden``
    with sigmoid and an fc with softmax over the vocabulary follow. The
    book's published widths are emb 32, hidden 256 over 4 context words.
    Returns the probabilities var."""
    if layers is None:
        from ..fluid import layers
    embs = [layers.embedding(input=w, size=[dict_size, emb],
                             is_sparse=is_sparse, param_attr="shared_w")
            for w in words]
    concat = layers.concat(input=embs, axis=1)
    hidden1 = layers.fc(input=concat, size=hidden, act="sigmoid")
    return layers.fc(input=hidden1, size=dict_size, act="softmax")


def build_tiny_lm(vocab=32, emb=16, heads=2, n_layers=2, max_pos=256,
                  seed=7):
    """Decoder-only LM (reference testing/models.py:129): token + learned
    position embeddings, ``n_layers`` blocks (fc q/k/v ->
    causal_self_attention -> residual + layer_norm -> fc(2·emb, relu) ->
    fc(emb) -> residual + layer_norm), a vocab logits head. Feeds
    ``tokens`` / ``positions`` [b, seq, 1] int64, fetches logits [b, seq,
    vocab]. Returns (main, startup, logits_var)."""
    from .. import fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    layers = fluid.layers
    with fluid.program_guard(main, startup):
        tokens = layers.data("tokens", shape=[-1, 1], dtype="int64")
        positions = layers.data("positions", shape=[-1, 1], dtype="int64")
        x = layers.elementwise_add(
            layers.embedding(tokens, size=[vocab, emb]),
            layers.embedding(positions, size=[max_pos, emb]))
        for _ in range(n_layers):
            q = layers.fc(x, size=emb, num_flatten_dims=2)
            k = layers.fc(x, size=emb, num_flatten_dims=2)
            v = layers.fc(x, size=emb, num_flatten_dims=2)
            a = layers.causal_self_attention(q, k, v, num_heads=heads)
            x = layers.layer_norm(layers.elementwise_add(x, a),
                                  begin_norm_axis=2)
            h = layers.fc(x, size=emb * 2, num_flatten_dims=2, act="relu")
            h = layers.fc(h, size=emb, num_flatten_dims=2)
            x = layers.layer_norm(layers.elementwise_add(x, h),
                                  begin_norm_axis=2)
        logits = layers.fc(x, size=vocab, num_flatten_dims=2)
    return main, startup, logits


def export_tiny_lm(dirname, scope=None, place=None, **kw):
    """Build, initialize (on ``place``: the card unless ``CPUPlace()``)
    and ``save_inference_model`` a tiny LM bundle at ``dirname`` (reference
    testing/models.py:165). Returns (main, scope holding its parameters,
    logits_var)."""
    from .. import fluid

    main, startup, logits = build_tiny_lm(**kw)
    exe = fluid.Executor(place)
    scope = scope or fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ["tokens", "positions"],
                                  [logits], exe, main, scope=scope)
    return main, scope, logits
