"""fluid.layers — the layer functions ported so far."""

from . import nn, io, sequence, tensor
from .nn import (fc, embedding, softmax, cross_entropy,  # noqa: F401
                 elementwise_add, elementwise_sub, square, conv2d, pool2d,
                 batch_norm, softmax_with_cross_entropy, mean, topk, warpctc,
                 ctc_greedy_decoder, edit_distance, layer_norm,
                 causal_self_attention)
from .io import data  # noqa: F401
from .sequence import (dynamic_lstm, dynamic_gru,  # noqa: F401
                       sequence_pool, sequence_last_step)
from .tensor import concat  # noqa: F401
