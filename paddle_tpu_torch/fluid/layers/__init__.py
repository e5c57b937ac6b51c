"""fluid.layers — the layer functions this slice ports."""

from . import nn, io
from .nn import (fc, softmax, elementwise_add, conv2d, pool2d,  # noqa: F401
                 batch_norm, softmax_with_cross_entropy, mean)
from .io import data  # noqa: F401
