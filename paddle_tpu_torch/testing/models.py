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
* ``build_mlp`` / ``build_convnet_slice`` (with ``mlp_feed`` /
  ``convnet_feed``): the reference's small training programs
  (paddle_tpu/testing/models.py:18, :52), an fc stack and a conv+BN
  residual slice, each with softmax_with_cross_entropy and an optimizer;
* ``nmt_train_program`` / ``nmt_decode_program`` (with ``nmt_pairs`` and
  ``nmt_feed``): the attention-free Seq2Seq NMT model of
  tests/book/test_machine_translation.py:31-147, encoder embedding -> fc
  -> dynamic_lstm -> last step, a dynamic_gru decoder started from the
  encoder's ``boot`` state and trained per token, and a While-loop beam
  search (gru_unit, topk, beam_search, batch_gather, beam_search_decode);
* ``build_tiny_lm`` / ``export_tiny_lm``: the decoder-only LM the
  generation engine serves (paddle_tpu/testing/models.py:129, :165), with
  the reference's defaults, op order and parameter names.

``layers`` is the fluid.layers namespace to build with: this package's by
default. Any module with the same layer API builds the same program, which
is how the tests build the reference package's twin of a port program.
"""

from __future__ import annotations

import numpy as np


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


def build_mlp(dim=16, classes=4, hidden=32, opt="momentum", lr=0.1, seed=7,
              depth=1, return_logits=False):
    """``depth`` relu fcs of width ``hidden`` over an ``img`` [dim] feed,
    an fc to ``classes`` logits, mean softmax_with_cross_entropy against
    an int64 ``label`` [1], and Momentum(lr, 0.9) (``opt="momentum"``) or
    Adam(min(lr, 1e-2)). Returns (main, startup, loss) and the logits too
    with ``return_logits``."""
    from .. import fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[dim])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        h = img
        for _ in range(depth):
            h = fluid.layers.fc(h, size=hidden, act="relu")
        logits = fluid.layers.fc(h, size=classes, act=None)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        if opt == "momentum":
            fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(
                loss, startup)
        else:
            fluid.optimizer.Adam(learning_rate=min(lr, 1e-2)).minimize(
                loss, startup)
    if return_logits:
        return main, startup, loss, logits
    return main, startup, loss


def mlp_feed(batch, dim=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "img": rng.normal(0, 1, (batch, dim)).astype("float32"),
        "label": rng.randint(0, classes, (batch, 1)).astype("int64"),
    }


def build_convnet_slice(size=8, classes=4, nf=8, lr=0.05, seed=7,
                        bottleneck=False):
    """conv+BN NHWC + residual + pools + fc + momentum over an ``img``
    [size, size, 3] feed. With ``bottleneck``, the stem / 1x1-3x3-1x1 /
    projection structure of ``resnet``. Returns (main, startup, loss)."""
    from .. import fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed

    def conv_bn(x, filters, k, stride=1, act="relu"):
        c = fluid.layers.conv2d(x, num_filters=filters, filter_size=k,
                                stride=stride, padding=(k - 1) // 2,
                                bias_attr=False, data_format="NHWC")
        return fluid.layers.batch_norm(c, act=act, data_layout="NHWC")

    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[size, size, 3])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        if bottleneck:
            stem = conv_bn(img, nf, 3, stride=2)
            pool = fluid.layers.pool2d(stem, pool_size=3, pool_stride=2,
                                       pool_padding=1, pool_type="max",
                                       data_format="NHWC")
            b = conv_bn(pool, nf // 2, 1)
            b = conv_bn(b, nf // 2, 3)
            b = conv_bn(b, nf * 2, 1, act=None)
            short = conv_bn(pool, nf * 2, 1, act=None)
            x = fluid.layers.elementwise_add(x=b, y=short, act="relu")
        else:
            c = conv_bn(img, nf, 3)
            c2 = conv_bn(c, nf, 3, act=None)
            x = fluid.layers.elementwise_add(x=c2, y=c, act="relu")
            x = fluid.layers.pool2d(x, pool_size=2, pool_stride=2,
                                    pool_type="avg", data_format="NHWC")
        x = fluid.layers.pool2d(x, pool_size=2, global_pooling=True,
                                pool_type="avg", data_format="NHWC")
        logits = fluid.layers.fc(x, size=classes, act=None)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(
            loss, startup)
    return main, startup, loss


def convnet_feed(batch, size=8, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "img": rng.normal(0, 1, (batch, size, size, 3)).astype("float32"),
        "label": rng.randint(0, classes, (batch, 1)).astype("int64"),
    }


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


# ---------------------------------------------------------------------------
# Seq2Seq NMT (tests/book/test_machine_translation.py:31-147)
# ---------------------------------------------------------------------------

NMT_BOS, NMT_EOS = 0, 1


def nmt_encoder(fluid, src_word, src_dict, emb, hid):
    """embedding(src_dict, emb) -> fc(4·hid, tanh) -> dynamic_lstm(hid) ->
    last step: [b, hid]. Every parameter is named, so the train and decode
    programs share them through one scope."""
    layers = fluid.layers
    e = layers.embedding(src_word, size=[src_dict, emb],
                         param_attr=fluid.ParamAttr(name="src_emb_w"))
    fc1 = layers.fc(e, size=hid * 4, act="tanh",
                    param_attr=fluid.ParamAttr(name="enc_fc_w"),
                    bias_attr=fluid.ParamAttr(name="enc_fc_b"))
    lstm_h, _ = layers.dynamic_lstm(
        fc1, size=hid * 4, param_attr=fluid.ParamAttr(name="enc_lstm_w"),
        bias_attr=fluid.ParamAttr(name="enc_lstm_b"))
    return layers.sequence_last_step(lstm_h)


def _nmt_boot(fluid, enc, hid):
    return fluid.layers.fc(enc, size=hid, act="tanh",
                           param_attr=fluid.ParamAttr(name="boot_w"),
                           bias_attr=fluid.ParamAttr(name="boot_b"))


def nmt_train_program(fluid, src_dict=24, trg_dict=24, emb=24, hid=48,
                      lr=0.01):
    """The training program (book test :61): the decoder is a dynamic_gru
    over the embedded target prefix started from ``boot`` (its H0),
    softmax over ``trg_dict``, mean cross entropy against the next token,
    Adam(lr). Feeds int64 LoD ``src``, ``trg``, ``trg_next``. Returns
    (main, startup, avg_cost, {"enc": encoder state var, "boot": the
    decoder's H0 var})."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = layers.data("src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data("trg", shape=[1], dtype="int64", lod_level=1)
        trg_next = layers.data("trg_next", shape=[1], dtype="int64",
                               lod_level=1)
        enc = nmt_encoder(fluid, src, src_dict, emb, hid)
        boot = _nmt_boot(fluid, enc, hid)
        trg_emb = layers.embedding(
            trg, size=[trg_dict, emb],
            param_attr=fluid.ParamAttr(name="trg_emb_w"))
        dec_in = layers.fc(trg_emb, size=hid * 3,
                           param_attr=fluid.ParamAttr(name="dec_in_w"),
                           bias_attr=fluid.ParamAttr(name="dec_in_b"))
        dec_h = layers.dynamic_gru(
            dec_in, size=hid, h_0=boot,
            param_attr=fluid.ParamAttr(name="gru_w"),
            bias_attr=fluid.ParamAttr(name="gru_b"))
        logits = layers.fc(dec_h, size=trg_dict,
                           param_attr=fluid.ParamAttr(name="out_w"),
                           bias_attr=fluid.ParamAttr(name="out_b"),
                           act="softmax")
        avg_cost = layers.mean(layers.cross_entropy(input=logits,
                                                    label=trg_next))
        fluid.optimizer.Adam(learning_rate=lr).minimize(avg_cost, startup)
    return main, startup, avg_cost, {"enc": enc, "boot": boot}


def nmt_decode_program(fluid, batch, src_dict=24, trg_dict=24, emb=24,
                       hid=48, beam=3, max_len=8):
    """The beam-search decoder (book test :86) over the trained parameter
    names: ``batch`` sources, ``beam`` beams of dense [batch, beam] state,
    ``max_len`` steps of a While loop (counter and limit fill_constants,
    tensor arrays of ids and parents), then beam_search_decode. Feeds
    ``src`` (int64 LoD), ``init_ids`` [batch, beam] int64 (<s>),
    ``init_scores`` [batch, beam] (0 for beam 0, -1e9 for the rest) and
    ``state_seed`` [batch, beam, hid] zeros. Returns (main, startup,
    sentence ids (2-level LoD), sentence scores, the encoder state var)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = layers.data("src", shape=[1], dtype="int64", lod_level=1)
        enc = nmt_encoder(fluid, src, src_dict, emb, hid)
        boot = _nmt_boot(fluid, enc, hid)
        init_ids = layers.data("init_ids", shape=[beam], dtype="int64")
        init_scores = layers.data("init_scores", shape=[beam],
                                  dtype="float32")
        state = layers.data("state_seed", shape=[beam, hid],
                            dtype="float32")
        state = layers.elementwise_add(
            state, layers.reshape(boot, [batch, 1, hid]))
        counter = layers.fill_constant(shape=(), dtype="int64", value=0)
        limit = layers.fill_constant(shape=(), dtype="int64", value=max_len)
        ids_arr = layers.array_write(init_ids, counter, cap=max_len + 1)
        parents_arr = layers.array_write(
            layers.cast(init_scores, "int64"), counter, cap=max_len + 1)
        scores_var = init_scores
        cond = layers.less_than(counter, limit)
        w = layers.While(cond)
        with w.block():
            pre_ids = layers.array_read(ids_arr, counter)   # [b, beam]
            e = layers.embedding(
                pre_ids, size=[trg_dict, emb],
                param_attr=fluid.ParamAttr(name="trg_emb_w"))
            flat_emb = layers.reshape(e, [batch * beam, emb])
            flat_state = layers.reshape(state, [batch * beam, hid])
            gin = layers.fc(flat_emb, size=hid * 3,
                            param_attr=fluid.ParamAttr(name="dec_in_w"),
                            bias_attr=fluid.ParamAttr(name="dec_in_b"))
            new_h, _, _ = layers.gru_unit(
                gin, flat_state, size=hid * 3,
                param_attr=fluid.ParamAttr(name="gru_w"),
                bias_attr=fluid.ParamAttr(name="gru_b"))
            prob = layers.fc(new_h, size=trg_dict,
                             param_attr=fluid.ParamAttr(name="out_w"),
                             bias_attr=fluid.ParamAttr(name="out_b"),
                             act="softmax")
            topk_scores, topk_ids = layers.topk(layers.log(prob), k=beam)
            sel_ids, sel_scores, parents = layers.beam_search(
                pre_ids, scores_var,
                layers.reshape(topk_ids, [batch, beam, beam]),
                layers.reshape(topk_scores, [batch, beam, beam]),
                beam_size=beam, end_id=NMT_EOS)
            # the state reordered by parent beam, then advanced
            layers.assign(layers.batch_gather(
                layers.reshape(new_h, [batch, beam, hid]), parents), state)
            layers.assign(sel_scores, scores_var)
            layers.increment(counter, 1)
            layers.array_write(sel_ids, counter, array=ids_arr)
            layers.array_write(parents, counter, array=parents_arr)
            layers.less_than(counter, limit, cond=cond)
        sent_ids, sent_scores = layers.beam_search_decode(
            ids_arr, parents_arr, scores_var, end_id=NMT_EOS)
    return main, startup, sent_ids, sent_scores, enc


def nmt_pairs(n, seed, dict_size, min_len=2, max_len=8, vocab=None):
    """``n`` synthetic translation triples (src, [<s>] + trg, trg + [<e>])
    with the reference dataset's ids (<s> 0, <e> 1, <unk> 2; the reference
    package's paddle_tpu/dataset/wmt14.py:63 task): the source core is
    ``min_len``..``max_len - 1`` tokens drawn from the seed, wrapped in
    <s>/<e>, and the target is the core reversed through a fixed token
    permutation. ``vocab`` caps the dictionary the task uses (the
    reference's synthetic task uses 33 ids; default all of
    ``dict_size``)."""
    rng = np.random.RandomState(seed)
    usable = min(dict_size, vocab or dict_size) - 3
    perm = np.random.RandomState(77).permutation(usable)
    out = []
    for _ in range(n):
        ln = int(rng.randint(min_len, max_len))
        core = rng.randint(0, usable, ln)
        trg = [int(t) + 3 for t in perm[core[::-1]]]
        out.append(([0] + [int(t) + 3 for t in core] + [1], [0] + trg,
                    trg + [1]))
    return out


def nmt_feed(triples):
    """The training feed of a list of triples: per-sequence [len, 1] int64
    arrays for ``src``, ``trg`` and ``trg_next``."""
    return {k: [np.asarray(t[i], "int64").reshape(-1, 1) for t in triples]
            for i, k in enumerate(("src", "trg", "trg_next"))}
