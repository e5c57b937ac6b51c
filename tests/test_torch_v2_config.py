"""The legacy layer DSL (v2/config_helpers.py, trainer_config_helpers,
v2.layer) in the port against the reference's: each config parsed by both
packages builds the same program op for op (types, slots, attrs, and
every variable's name, dtype, shape and LoD level, before and after the
settings() optimizer's minimize), and trained 5 steps on one seeded feed,
the port from the reference's startup state, the losses agree within
1e-5 relative.

The configs: bench.py's reference RNN benchmark (benchmark/paddle/rnn/rnn.py,
tests/test_v2_config.py's verbatim RNN_CONFIG at narrow widths), the
paddle_trainer CLI's fc config (tests/test_trainer_cli.py), an MNIST-style
net in the v2.layer spelling, the image layers (conv, img_cmrnorm, pool,
batch_norm, dropout at rate 0: the packages draw masks from different
generators), mixed_layer projections, simple_gru, ctc_layer, layer
arithmetic, and the layers over this slice's ops (maxout, pad,
block_expand, rank_cost, nce; nce draws its negatives, so that config is
held by its program and a finite falling loss)."""

import importlib

import numpy as np
import pytest

from torch_cross import (build_both, assert_same_program, cross_losses,
                         jfluid, tfluid)
import test_v2_config
import test_trainer_cli
from paddle_tpu_torch.testing import legacy_lane as lane

RNN_CONFIG, CLI_CONFIG = lane.RNN_CONFIG, lane.CLI_CONFIG


def _pkg(fluid):
    return "paddle_tpu" if fluid is jfluid else "paddle_tpu_torch"


def _v2(fluid):
    return importlib.import_module(_pkg(fluid) + ".v2")


def _parsed(source, config_args=None, sequence_inputs=()):
    """A build for ``build_both``: the config parsed by the package's
    parse_config, then its settings() optimizer's minimize."""
    def build(fluid):
        ch = importlib.import_module(_pkg(fluid) + ".v2.config_helpers")
        topo, main, startup = ch.parse_config(
            source, config_args=config_args,
            sequence_inputs=sequence_inputs)
        main.random_seed = startup.random_seed = 1
        before = main.clone()
        with fluid.program_guard(main, startup):
            topo.create_optimizer().minimize(topo.cost, startup)
        return main, startup, topo.cost, before
    return build


def _mnist_v2(fluid):
    paddle = _v2(fluid)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        img = paddle.layer.data("pixel", paddle.data_type.dense_vector(64),
                                height=8, width=8)
        conv = paddle.layer.img_conv(img, filter_size=3, num_filters=4,
                                     num_channels=1, padding=1,
                                     act=paddle.activation.Relu())
        pool = paddle.layer.img_pool(conv, pool_size=2, stride=2,
                                     pool_type=paddle.pooling.Max())
        pred = paddle.layer.fc(pool, size=5, act=paddle.activation.Softmax())
        label = paddle.layer.data("label", paddle.data_type.integer_value(5))
        cost = paddle.layer.classification_cost(input=pred, label=label)
        before = main.clone()
        paddle.optimizer.Momentum(momentum=0.9, learning_rate=0.1) \
            .to_fluid().minimize(cost.var, startup)
    return main, startup, cost.var, before


IMAGE_CONFIG = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.01,
         learning_method=MomentumOptimizer(0.9),
         regularization=L2Regularization(1e-4))
img = data_layer('image', size=3 * 8 * 8, height=8, width=8)
c = img_conv_layer(input=img, filter_size=3, num_filters=6, num_channels=3,
                   padding=1, act=ReluActivation())
c = img_cmrnorm_layer(input=c, size=5, scale=0.0128, power=0.75)
c = img_pool_layer(input=c, pool_size=3, stride=2, pool_type=MaxPooling())
c = batch_norm_layer(input=c, act=ReluActivation())
c = dropout_layer(c, 0.0)
out = fc_layer(input=c, size=4, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=data_layer('label', 4)))
"""

MIXED_CONFIG = """
from paddle_tpu.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.05, learning_method=AdamOptimizer())
x = data_layer('x', size=10)
with mixed_layer(size=6, act=TanhActivation(), bias_attr=True) as m:
    m += full_matrix_projection(input=x)
    m += identity_projection(input=x, offset=2)
    m += dotmul_projection(input=fc_layer(input=x, size=6))
y = 1 + m
y = y * 2 - 0.5
out = fc_layer(input=[y, x], size=3, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=data_layer('label', 3)))
"""

GRU_CONFIG = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=2e-3, learning_method=AdamOptimizer())
words = data_layer('words', size=30)
emb = embedding_layer(input=words, size=8)
g = simple_gru(input=emb, size=16)
out = fc_layer(input=last_seq(input=g), size=2, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=data_layer('label', 2)))
"""

CTC_CONFIG = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.01, learning_method=AdamOptimizer())
feat = data_layer('feat', size=6)
h = simple_gru(input=feat, size=16)
logits = fc_layer(input=h, size=5)
outputs(ctc_layer(input=logits, label=data_layer('label', 5), size=5))
"""

NEW_OPS_CONFIG = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.05)
img = data_layer('image', size=4 * 6 * 6, height=6, width=6)
m = maxout_layer(input=img, groups=2, num_channels=4)
p = pad_layer(input=m, pad_c=[1, 1], pad_h=[0, 1], pad_w=[1, 0])
s = block_expand_layer(input=p, num_channels=4, block_x=2, block_y=2,
                       stride_x=2, stride_y=2)
f = pooling_layer(input=s, pooling_type=AvgPooling())
left = fc_layer(input=f, size=1)
right = fc_layer(input=f, size=1)
rc = rank_cost(left=left, right=right, label=data_layer('order', 1))
nc = nce_layer(input=f, label=data_layer('cls', 7), num_classes=7,
               num_neg_samples=3)
outputs(rc + nc)
"""

RNN_ARGS = {"batch_size": 4, "hidden_size": 16, "vocab_size": 40,
            "emb_size": 8, "lstm_num": 2}


def _seqs(rng, n, vocab, lens=(3, 9)):
    return [rng.randint(0, vocab, (int(rng.randint(*lens)), 1))
            .astype("int64") for _ in range(n)]


def _labels(rng, n, k):
    return rng.randint(0, k, (n, 1)).astype("int64")


FEEDS = {
    "rnn": lambda rng: {"data": _seqs(rng, 4, 40),
                        "label": _labels(rng, 4, 2)},
    "cli_fc": lambda rng: {"data": rng.normal(0, 1, (8, 12))
                           .astype("float32"), "label": _labels(rng, 8, 4)},
    "mnist_v2": lambda rng: {"pixel": rng.normal(0, 1, (6, 64))
                             .astype("float32"),
                             "label": _labels(rng, 6, 5)},
    "image": lambda rng: {"image": rng.normal(0, 1, (4, 192))
                          .astype("float32"), "label": _labels(rng, 4, 4)},
    "mixed": lambda rng: {"x": rng.normal(0, 1, (4, 10)).astype("float32"),
                          "label": _labels(rng, 4, 3)},
    "gru": lambda rng: {"words": _seqs(rng, 4, 30),
                        "label": _labels(rng, 4, 2)},
    "ctc": lambda rng: {
        "feat": [rng.normal(0, 1, (int(n), 6)).astype("float32")
                 for n in (7, 9, 6, 8)],
        "label": [rng.randint(0, 4, (int(n), 1)).astype("int64")
                  for n in (2, 3, 1, 2)]},
}

BUILDS = {
    "rnn": _parsed(RNN_CONFIG, RNN_ARGS),
    "cli_fc": _parsed(CLI_CONFIG),
    "mnist_v2": _mnist_v2,
    "image": _parsed(IMAGE_CONFIG),
    "mixed": _parsed(MIXED_CONFIG),
    "gru": _parsed(GRU_CONFIG),
    "ctc": _parsed(CTC_CONFIG, sequence_inputs=("feat",)),
    "new_ops": _parsed(NEW_OPS_CONFIG),
}


@pytest.fixture(scope="module")
def built():
    return {k: build_both(b) for k, b in BUILDS.items()}


@pytest.mark.parametrize("config", sorted(BUILDS))
def test_config_builds_the_reference_program(built, config):
    progs = built[config]
    assert_same_program(progs["port"][3], progs["ref"][3])
    assert_same_program(progs["port"][0], progs["ref"][0])
    assert_same_program(progs["port"][1], progs["ref"][1])


@pytest.mark.parametrize("config", sorted(FEEDS))
def test_config_trains_as_the_reference(config):
    rng = np.random.RandomState(sorted(FEEDS).index(config))
    got, want = cross_losses(build_both(BUILDS[config]),
                             FEEDS[config](rng), steps=5)
    assert np.isfinite(got).all()


def test_new_op_layers_train_on_the_port():
    fluid = tfluid
    fluid.framework.reset_unique_name()
    main, startup, cost, _ = BUILDS["new_ops"](fluid)
    rng = np.random.RandomState(4)
    feed = {"image": rng.normal(0, 1, (4, 144)).astype("float32"),
            "order": rng.randint(0, 2, (4, 1)).astype("float32"),
            "cls": _labels(rng, 4, 7)}
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0].mean()) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_lazy_data_layers_decide_alike():
    """The first consumer decides each data layer's dtype and LoD level:
    an embedding makes an int64 sequence, a cost label int64 [-1, 1], a
    sequence hint makes a dense feature sequence."""
    progs = built_rnn = build_both(_parsed(RNN_CONFIG, RNN_ARGS))
    block = built_rnn["port"][0].global_block()
    assert (block.var("data").dtype, block.var("data").lod_level) == \
        ("int64", 1)
    assert block.var("label").dtype == "int64"
    ctc = build_both(_parsed(CTC_CONFIG, sequence_inputs=("feat",)))
    feat = ctc["port"][0].global_block().var("feat")
    assert (feat.dtype, feat.lod_level, feat.shape[-1]) == \
        ("float32", 1, 6)
    assert progs["port"][0].global_block().var("data").shape == \
        progs["ref"][0].global_block().var("data").shape


def test_parse_config_keeps_the_port_name():
    """``paddle_tpu_torch.`` in a config stays as it is."""
    from paddle_tpu_torch.v2.config_helpers import _PACKAGE_NAMES
    src = ("from paddle_tpu_torch.trainer_config_helpers import *\n"
           "from paddle.trainer_config_helpers import *\n"
           "import paddle_tpu.v2\n")
    assert _PACKAGE_NAMES.sub("paddle_tpu_torch", src) == (
        "from paddle_tpu_torch.trainer_config_helpers import *\n"
        "from paddle_tpu_torch.trainer_config_helpers import *\n"
        "import paddle_tpu_torch.v2\n")


def _code(text):
    return [ln for ln in text.strip().splitlines()
            if ln.strip() and not ln.startswith("#")
            and "trainer_config_helpers import" not in ln]


def test_the_lane_configs_are_the_reference_tests_configs():
    """testing/legacy_lane.py's rnn.py and fc config are, line for line,
    the ones the JAX package's tests parse (tests/test_v2_config.py,
    tests/test_trainer_cli.py), but for the import's package name."""
    assert _code(lane.RNN_CONFIG) == _code(test_v2_config.RNN_CONFIG)
    assert _code(lane.CLI_CONFIG) == _code(test_trainer_cli.CONFIG)
