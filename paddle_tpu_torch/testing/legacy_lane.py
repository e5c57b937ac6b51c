"""The reference's RNN benchmark config (benchmark/paddle/rnn/rnn.py) as
paddle_trainer runs it: the config text without its data-provider lines
(the IMDB download and define_py_data_sources2, for which ``--reader``
stands in), the paddle_trainer tests' fc config, and a reader of id
sequences whose label the net can learn: the parity of the last token.

``reader`` is what ``--reader=paddle_tpu_torch.testing.legacy_lane:reader``
names; it reads its sizes from this module's globals (the published
lane's by default: batch 64 of 100-long sequences over 30000 ids, 8
batches), which a caller may set first.
"""

from __future__ import annotations

import numpy as np

# benchmark/paddle/rnn/rnn.py, verbatim but for its data-provider lines
RNN_CONFIG = """
from paddle.trainer_config_helpers import *

num_class = 2
vocab_size = get_config_arg('vocab_size', int, 30000)
fixedlen = 100
batch_size = get_config_arg('batch_size', int, 128)
lstm_num = get_config_arg('lstm_num', int, 1)
hidden_size = get_config_arg('hidden_size', int, 128)
emb_size = get_config_arg('emb_size', int, 128)

settings(
    batch_size=batch_size,
    learning_rate=2e-3,
    learning_method=AdamOptimizer(),
    regularization=L2Regularization(8e-4),
    gradient_clipping_threshold=25)

net = data_layer('data', size=vocab_size)
net = embedding_layer(input=net, size=emb_size)

for i in xrange(lstm_num):
    net = simple_lstm(input=net, size=hidden_size)

net = last_seq(input=net)
net = fc_layer(input=net, size=2, act=SoftmaxActivation())

lab = data_layer('label', num_class)
loss = classification_cost(input=net, label=lab)
outputs(loss)
"""

# bench.py:238's lane through rnn.py's config arguments: its published
# widths, two LSTMs, batch 64 (the largest batch lstm_seq takes)
RNN_ARGS = {"vocab_size": 30000, "emb_size": 128, "hidden_size": 512,
            "lstm_num": 2, "batch_size": 64}

# tests/test_trainer_cli.py's config
CLI_CONFIG = """
from paddle.trainer_config_helpers import *

num_class = 4
batch_size = get_config_arg('batch_size', int, 8)

settings(batch_size=batch_size, learning_rate=0.05,
         learning_method=MomentumOptimizer(0.9))

net = data_layer('data', size=12)
net = fc_layer(input=net, size=10, act=ReluActivation())
net = fc_layer(input=net, size=num_class, act=SoftmaxActivation())
lab = data_layer('label', num_class)
loss = classification_cost(input=net, label=lab)
outputs(loss)
"""

SEED, BATCHES, BATCH, LENGTH, VOCAB = 0, 8, 64, 100, 30000


def parity_batches(seed=None, batches=None, batch=None, length=None,
                   vocab=None):
    """``batches`` batches of ``batch`` (ids [length, 1] int64, [label])
    rows from ``RandomState(seed)``, the label the parity of the last id;
    None takes this module's global."""
    g = globals()
    seed, batches, batch, length, vocab = (
        g[k] if v is None else v for k, v in (
            ("SEED", seed), ("BATCHES", batches), ("BATCH", batch),
            ("LENGTH", length), ("VOCAB", vocab)))
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        ids = rng.randint(0, vocab, (batch, length, 1)).astype("int64")
        out.append([(ids[i], [int(ids[i, -1, 0] % 2)])
                    for i in range(batch)])
    return out


def reader():
    """A reader creator over ``parity_batches()`` (paddle_trainer's
    ``--reader`` contract: each item is one batch of rows)."""
    batches = parity_batches()
    return lambda: iter(batches)
