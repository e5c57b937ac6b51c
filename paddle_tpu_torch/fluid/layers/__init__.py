"""fluid.layers — the layer functions ported so far."""

from . import nn, io, sequence
from .nn import (fc, embedding, softmax, cross_entropy,  # noqa: F401
                 elementwise_add, conv2d, pool2d, batch_norm,
                 softmax_with_cross_entropy, mean)
from .io import data  # noqa: F401
from .sequence import (dynamic_lstm, sequence_pool,  # noqa: F401
                       sequence_last_step)
