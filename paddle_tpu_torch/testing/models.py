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
* ``build_mlp`` / ``build_convnet_slice`` / ``build_seq_slice`` (with
  ``mlp_feed`` / ``convnet_feed`` / ``seq_feed``): the reference's small
  training programs (paddle_tpu/testing/models.py:18, :52, :104), an fc
  stack and a conv+BN residual slice, each with softmax_with_cross_entropy
  and an optimizer, and a LoD embedding + GRU step with Adam;
* ``nmt_train_program`` / ``nmt_decode_program`` (with ``nmt_pairs`` and
  ``nmt_feed``): the attention-free Seq2Seq NMT model of
  tests/book/test_machine_translation.py:31-147, encoder embedding -> fc
  -> dynamic_lstm -> last step, a dynamic_gru decoder started from the
  encoder's ``boot`` state and trained per token, and a While-loop beam
  search (gru_unit, topk, beam_search, batch_gather, beam_search_decode);
* ``build_tiny_lm`` / ``export_tiny_lm``: the decoder-only LM the
  generation engine serves (paddle_tpu/testing/models.py:129, :165), with
  the reference's defaults, op order and parameter names.
* the book chapters of tests/book/, each taking ``fluid``: ``digits_mlp``
  and ``digits_conv`` (recognize_digits), ``cifar_resnet`` and
  ``cifar_vgg`` (image_classification's resnet_cifar10 and
  vgg16_bn_drop), ``sentiment_conv`` and ``sentiment_lstm``
  (understand_sentiment's convolution_net and stacked_lstm_net),
  ``srl_db_lstm`` (label_semantic_roles) and ``recommender``, with
  ``book_feed`` for their synthetic batches.

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


def build_seq_slice(vocab=12, emb=8, hid=8, lr=1e-2, seed=7):
    """A LoD training step (reference testing/models.py:104): int64
    ``src`` and ``tgt`` sequences (lod_level 1) through embedding -> fc ->
    dynamic_gru -> fc(softmax) -> per-token cross_entropy -> mean, and
    Adam(lr). Returns (main, startup, loss)."""
    from .. import fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        src = fluid.layers.data("src", shape=[1], dtype="int64", lod_level=1)
        tgt = fluid.layers.data("tgt", shape=[1], dtype="int64", lod_level=1)
        e = fluid.layers.embedding(src, size=[vocab, emb])
        h = fluid.layers.fc(e, size=hid * 3)
        h = fluid.layers.dynamic_gru(h, size=hid)
        logits = fluid.layers.fc(h, size=vocab, act="softmax")
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=logits, label=tgt))
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss, startup)
    return main, startup, loss


def seq_feed(batch, vocab=12, min_len=2, max_len=7, seed=0):
    """``batch`` random sequences of min_len..max_len-1 tokens, fed as both
    ``src`` and ``tgt`` (reference testing/models.py:122)."""
    rng = np.random.RandomState(seed)
    lens = [int(rng.randint(min_len, max_len)) for _ in range(batch)]
    seqs = [rng.randint(0, vocab, (ln, 1)).astype("int64") for ln in lens]
    return {"src": list(seqs), "tgt": list(seqs)}


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


# ---------------------------------------------------------------------------
# The book chapters (tests/book/). Each builder takes the fluid module to
# build with and the chapter's widths (the book's by default), and returns
# (main, startup, v): v["loss"] the mean cost, v["feeds"] the data names in
# feed order and, where the chapter has them, v["predict"], v["acc"],
# v["decode"] (SRL's Viterbi paths) and v["target"]. ``book_feed`` makes a
# chapter's synthetic batch from a seed. The default optimizer is Adam at
# the book's rate (0.002; SRL 1e-4, its SGD rate: db_lstm diverges under
# Adam at 2e-3 at the book's widths) or the repo test's (the recommender's
# 0.01); ``opt`` (fluid -> optimizer) replaces it.
# ---------------------------------------------------------------------------

# vgg16_bn_drop's conv blocks (book chapter 3): (filters, convs, dropout
# rate after each conv's batch norm)
VGG16_BLOCKS = ((64, 2, (0.3, 0.0)), (128, 2, (0.4, 0.0)),
                (256, 3, (0.4, 0.4, 0.0)), (512, 3, (0.4, 0.4, 0.0)),
                (512, 3, (0.4, 0.4, 0.0)))


def _classifier_head(fluid, predict, label, v):
    """Mean cross entropy and accuracy of a softmax ``predict``, recorded
    in ``v``; returns the mean."""
    layers = fluid.layers
    avg = layers.mean(layers.cross_entropy(input=predict, label=label))
    v.update(loss=avg, predict=predict,
             acc=layers.accuracy(input=predict, label=label))
    return avg


def _build(fluid, body, opt, lr):
    """Run ``body(v)`` under a fresh program pair; it returns the loss,
    which the optimizer (``opt(fluid)`` or Adam(lr)) minimizes."""
    main, startup = fluid.Program(), fluid.Program()
    v = {}
    with fluid.program_guard(main, startup):
        loss = body(v)
        optimizer = opt(fluid) if opt else fluid.optimizer.Adam(
            learning_rate=lr)
        optimizer.minimize(loss, startup)
    return main, startup, v


def digits_mlp(fluid, hidden=(128, 64), lr=0.002, opt=None, inputs=None):
    """recognize_digits' MLP (tests/book/test_recognize_digits.py:30):
    784 -> 128 -> 64 relu -> 10 softmax. ``inputs(layers)``, where given,
    makes the (img, label) vars in the programs' guard (a reader graph's
    ``read_file``) in place of the two data layers."""
    layers = fluid.layers

    def body(v):
        if inputs is not None:
            img, label = inputs(layers)
        else:
            img = layers.data("img", shape=[784])
            label = layers.data("label", shape=[1], dtype="int64")
        h = img
        for size in hidden:
            h = layers.fc(input=h, size=size, act="relu")
        v["feeds"] = ["img", "label"]
        return _classifier_head(
            fluid, layers.fc(input=h, size=10, act="softmax"), label, v)
    return _build(fluid, body, opt, lr)


def digits_conv(fluid, filters=(20, 50), lr=0.002, opt=None):
    """The book's conv net for MNIST (chapter 2, conv_net): two
    simple_img_conv_pool (5x5, pool 2/2, relu) with a batch_norm between,
    then fc(10, softmax), on 1x28x28 images."""
    layers, nets = fluid.layers, fluid.nets

    def body(v):
        img = layers.data("img", shape=[1, 28, 28])
        label = layers.data("label", shape=[1], dtype="int64")
        h = nets.simple_img_conv_pool(input=img, filter_size=5,
                                      num_filters=filters[0], pool_size=2,
                                      pool_stride=2, act="relu")
        h = layers.batch_norm(h)
        h = nets.simple_img_conv_pool(input=h, filter_size=5,
                                      num_filters=filters[1], pool_size=2,
                                      pool_stride=2, act="relu")
        v["feeds"] = ["img", "label"]
        return _classifier_head(
            fluid, layers.fc(input=h, size=10, act="softmax"), label, v)
    return _build(fluid, body, opt, lr)


def cifar_resnet(fluid, depth=32, widths=(16, 32, 64), classes=10,
                 lr=0.002, opt=None):
    """image_classification's resnet_cifar10 (book chapter 3;
    tests/book/test_image_classification.py:59 at depth 8, widths 8/16/32):
    conv_bn stem, three stages of (depth - 2) / 6 basic blocks, global
    average pool, fc(classes, softmax), on 3x32x32 images."""
    layers = fluid.layers

    def conv_bn(x, ch_out, size, stride, padding, act="relu"):
        tmp = layers.conv2d(input=x, filter_size=size, num_filters=ch_out,
                            stride=stride, padding=padding, act=None,
                            bias_attr=False)
        return layers.batch_norm(input=tmp, act=act)

    def basicblock(x, ch_in, ch_out, stride):
        tmp = conv_bn(x, ch_out, 3, stride, 1)
        tmp = conv_bn(tmp, ch_out, 3, 1, 1, act=None)
        short = conv_bn(x, ch_out, 1, stride, 0, None) \
            if ch_in != ch_out else x
        return layers.elementwise_add(x=tmp, y=short, act="relu")

    def body(v):
        assert (depth - 2) % 6 == 0
        n = (depth - 2) // 6
        images = layers.data("pixel", shape=[3, 32, 32])
        label = layers.data("label", shape=[1], dtype="int64")
        h = conv_bn(images, widths[0], 3, 1, 1)
        ch = widths[0]
        for i, w in enumerate(widths):
            for j in range(n):
                h = basicblock(h, ch, w, 2 if i and not j else 1)
                ch = w
        pool = layers.pool2d(input=h, pool_size=8, pool_type="avg",
                             pool_stride=1, global_pooling=True)
        v["feeds"] = ["pixel", "label"]
        return _classifier_head(
            fluid, layers.fc(input=pool, size=classes, act="softmax"),
            label, v)
    return _build(fluid, body, opt, lr)


def cifar_vgg(fluid, blocks=VGG16_BLOCKS, fc=512, classes=10, drop=1.0,
              lr=0.002, opt=None):
    """image_classification's vgg16_bn_drop (book chapter 3;
    tests/book/test_image_classification.py:44 with blocks of 16 and 32):
    img_conv_group blocks (conv, batch_norm + relu, dropout), dropout 0.5,
    fc, batch_norm + relu, dropout 0.5, fc, fc(classes, softmax). Every
    dropout rate is multiplied by ``drop``."""
    layers, nets = fluid.layers, fluid.nets

    def body(v):
        images = layers.data("pixel", shape=[3, 32, 32])
        label = layers.data("label", shape=[1], dtype="int64")
        h = images
        for filters, convs, rates in blocks:
            h = nets.img_conv_group(
                input=h, pool_size=2, pool_stride=2,
                conv_num_filter=[filters] * convs, conv_filter_size=3,
                conv_act="relu", conv_with_batchnorm=True,
                conv_batchnorm_drop_rate=[r * drop for r in rates],
                pool_type="max")
        h = layers.dropout(x=h, dropout_prob=0.5 * drop)
        h = layers.fc(input=h, size=fc, act=None)
        h = layers.batch_norm(input=h, act="relu")
        h = layers.dropout(x=h, dropout_prob=0.5 * drop)
        h = layers.fc(input=h, size=fc, act=None)
        v["feeds"] = ["pixel", "label"]
        return _classifier_head(
            fluid, layers.fc(input=h, size=classes, act="softmax"), label, v)
    return _build(fluid, body, opt, lr)


def sentiment_conv(fluid, dict_dim, emb=32, hid=32, classes=2, lr=0.002,
                   pool_type="sqrt", opt=None):
    """understand_sentiment's convolution_net (book chapter 6, at the book
    function's defaults): an embedding, two sequence_conv_pool towers
    (windows 3 and 4, tanh), fc(classes, softmax) over both."""
    layers, nets = fluid.layers, fluid.nets

    def body(v):
        words = layers.data("words", shape=[1], dtype="int64", lod_level=1)
        label = layers.data("label", shape=[1], dtype="int64")
        e = layers.embedding(input=words, size=[dict_dim, emb])
        towers = [nets.sequence_conv_pool(input=e, num_filters=hid,
                                          filter_size=k, act="tanh",
                                          pool_type=pool_type)
                  for k in (3, 4)]
        v["feeds"] = ["words", "label"]
        return _classifier_head(
            fluid, layers.fc(input=towers, size=classes, act="softmax"),
            label, v)
    return _build(fluid, body, opt, lr)


def sentiment_lstm(fluid, dict_dim, emb=128, hid=512, stacked=3, classes=2,
                   lr=0.002, opt=None):
    """understand_sentiment's stacked_lstm_net (book chapter 6): embedding,
    fc(hid) -> dynamic_lstm(hid, an LSTM of hid / 4 units), then
    ``stacked - 1`` more fc + dynamic_lstm over the previous pair,
    alternating direction; max-pooled last fc and LSTM into
    fc(classes, softmax)."""
    layers = fluid.layers

    def body(v):
        assert stacked % 2 == 1
        words = layers.data("words", shape=[1], dtype="int64", lod_level=1)
        label = layers.data("label", shape=[1], dtype="int64")
        e = layers.embedding(input=words, size=[dict_dim, emb])
        fc1 = layers.fc(input=e, size=hid)
        lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid)
        inputs = [fc1, lstm1]
        for i in range(2, stacked + 1):
            fc = layers.fc(input=inputs, size=hid)
            lstm, _ = layers.dynamic_lstm(input=fc, size=hid,
                                          is_reverse=i % 2 == 0)
            inputs = [fc, lstm]
        pooled = [layers.sequence_pool(input=x, pool_type="max")
                  for x in inputs]
        v["feeds"] = ["words", "label"]
        return _classifier_head(
            fluid, layers.fc(input=pooled, size=classes, act="softmax"),
            label, v)
    return _build(fluid, body, opt, lr)


SRL_FEEDS = ("word", "predicate", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
             "ctx_p2", "mark")


def srl_db_lstm(fluid, word_dict, pred_dict, label_dict, mark_dict=2,
                word_dim=32, mark_dim=5, hidden=512, depth=8,
                is_sparse=True, lr=1e-4, opt=None):
    """label_semantic_roles' db_lstm (book chapter 7): the eight features
    (the word, the predicate, five context words, the mark), the word
    ones through one frozen table "emb", each into fc(hidden), summed;
    ``depth`` dynamic_lstm layers of hidden / 4 units (candidate relu,
    cell sigmoid), alternating direction, each over the sum of two fcs of
    the previous pair; the sum of two fcs to ``label_dict`` tags as the
    emission of a linear-chain CRF ("crfw") and its Viterbi decode. The
    predicate and mark tables take ``is_sparse``. Feeds SRL_FEEDS and
    ``target``, all int64 LoD; v adds ``crf_cost`` (per sequence),
    ``feature``, ``target`` and ``decode``."""
    layers = fluid.layers
    param = fluid.ParamAttr

    def body(v):
        data = {n: layers.data(n, shape=[1], dtype="int64", lod_level=1)
                for n in SRL_FEEDS}
        target = layers.data("target", shape=[1], dtype="int64",
                             lod_level=1)
        embs = [layers.embedding(
            input=data[n], size=[word_dict, word_dim],
            param_attr=param(name="emb", trainable=False))
            for n in ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
                      "ctx_p2")]
        embs.append(layers.embedding(input=data["predicate"],
                                     size=[pred_dict, word_dim],
                                     is_sparse=is_sparse,
                                     param_attr=param(name="vemb")))
        embs.append(layers.embedding(input=data["mark"],
                                     size=[mark_dict, mark_dim],
                                     is_sparse=is_sparse))
        hidden_0 = layers.sums([layers.fc(input=e, size=hidden)
                                for e in embs])
        lstm_kw = dict(size=hidden, candidate_activation="relu",
                       gate_activation="sigmoid", cell_activation="sigmoid")
        pair = [hidden_0, layers.dynamic_lstm(input=hidden_0, **lstm_kw)[0]]
        for i in range(1, depth):
            mix = layers.sums([layers.fc(input=x, size=hidden)
                               for x in pair])
            pair = [mix, layers.dynamic_lstm(input=mix, is_reverse=i % 2 == 1,
                                             **lstm_kw)[0]]
        feature = layers.sums([layers.fc(input=x, size=label_dict)
                               for x in pair])
        crf_cost = layers.linear_chain_crf(input=feature, label=target,
                                           param_attr=param(name="crfw"))
        avg = layers.mean(crf_cost)
        v.update(loss=avg, crf_cost=crf_cost, feature=feature,
                 target=target, feeds=list(SRL_FEEDS) + ["target"],
                 decode=layers.crf_decoding(input=feature,
                                            param_attr=param(name="crfw")))
        return avg
    return _build(fluid, body, opt, lr)


def recommender(fluid, users, jobs, movies, categories, title_dict,
                lr=0.01, opt=None):
    """recommender_system's two towers (tests/book/
    test_recommender_system.py:24-66): user id, gender, age and job
    embeddings through fcs into fc(32, tanh); movie id, its categories
    (sum-pooled) and its title (sequence_conv_pool) into fc(32, tanh);
    cos_sim scaled by 5 against the rating by square_error_cost."""
    layers, nets = fluid.layers, fluid.nets

    def emb_fc(name, count, width, lod_level=0):
        ids = layers.data(name, shape=[1], dtype="int64",
                          lod_level=lod_level)
        return layers.embedding(ids, size=[count, width])

    def body(v):
        usr = [layers.fc(emb_fc("user_id", users, 16), size=16)] + [
            layers.fc(emb_fc(n, c, 8), size=8)
            for n, c in (("gender_id", 2), ("age_id", 7), ("job_id", jobs))]
        usr = layers.fc(layers.concat(usr, axis=1), size=32, act="tanh")
        mov = [layers.fc(emb_fc("movie_id", movies, 16), size=16),
               layers.sequence_pool(
                   emb_fc("category_id", categories, 8, 1), pool_type="sum"),
               nets.sequence_conv_pool(
                   input=emb_fc("movie_title", title_dict, 16, 1),
                   num_filters=16, filter_size=3, act="tanh",
                   pool_type="sum")]
        mov = layers.fc(layers.concat(mov, axis=1), size=32, act="tanh")
        predict = layers.scale(x=layers.cos_sim(X=usr, Y=mov), scale=5.0)
        score = layers.data("score", shape=[1], dtype="float32")
        avg = layers.mean(layers.square_error_cost(input=predict,
                                                   label=score))
        v.update(loss=avg, predict=predict, feeds=list(RECOMMENDER_FEEDS))
        return avg
    return _build(fluid, body, opt, lr)


RECOMMENDER_FEEDS = ("user_id", "gender_id", "age_id", "job_id", "movie_id",
                     "category_id", "movie_title", "score")


def _seqs(rng, n, lens, high):
    return [rng.randint(0, high, (int(rng.randint(lens[0], lens[1] + 1)),
                                  1)).astype("int64") for _ in range(n)]


def book_feed(chapter, batch, seed, **sizes):
    """A synthetic batch of ``chapter`` ("digits_mlp", "digits_conv",
    "cifar", "sentiment", "srl", "recommender") from ``seed``: images
    uniform in [0, 1), ids uniform over each dictionary, labels uniform.
    Sizes: ``classes`` (cifar, default 10); ``dict_dim`` and ``lens``
    (sentiment: sequences of lens[0]..lens[1] tokens); ``word_dict``,
    ``pred_dict``, ``label_dict`` and ``lens`` (srl); ``users``,
    ``jobs``, ``movies``, ``categories``, ``title_dict`` (recommender)."""
    rng = np.random.RandomState(seed)

    def labels(classes):
        return rng.randint(0, classes, (batch, 1)).astype("int64")

    if chapter == "digits_mlp":
        return {"img": rng.rand(batch, 784).astype("float32"),
                "label": labels(10)}
    if chapter == "digits_conv":
        return {"img": rng.rand(batch, 1, 28, 28).astype("float32"),
                "label": labels(10)}
    if chapter == "cifar":
        return {"pixel": rng.rand(batch, 3, 32, 32).astype("float32"),
                "label": labels(sizes.get("classes", 10))}
    if chapter == "sentiment":
        return {"words": _seqs(rng, batch, sizes["lens"], sizes["dict_dim"]),
                "label": labels(2)}
    if chapter == "srl":
        lens = [int(rng.randint(sizes["lens"][0], sizes["lens"][1] + 1))
                for _ in range(batch)]
        feed = {}
        for name in SRL_FEEDS + ("target",):
            high = {"predicate": sizes["pred_dict"], "mark": 2,
                    "target": sizes["label_dict"]}.get(name,
                                                       sizes["word_dict"])
            feed[name] = [rng.randint(0, high, (n, 1)).astype("int64")
                          for n in lens]
        for i, n in enumerate(lens):       # one predicate a sentence
            feed["predicate"][i][:] = feed["predicate"][i][0]
        return feed
    if chapter == "recommender":
        def ids(high):
            return rng.randint(0, high, (batch, 1)).astype("int64")
        return {"user_id": ids(sizes["users"]), "gender_id": ids(2),
                "age_id": ids(7), "job_id": ids(sizes["jobs"]),
                "movie_id": ids(sizes["movies"]),
                "category_id": _seqs(rng, batch, (1, 3),
                                     sizes["categories"]),
                "movie_title": _seqs(rng, batch, (1, 5),
                                     sizes["title_dict"]),
                "score": rng.randint(1, 6, (batch, 1)).astype("float32")}
    raise ValueError(f"unknown book chapter {chapter!r}")
