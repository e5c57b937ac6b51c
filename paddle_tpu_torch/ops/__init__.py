"""Op lowerings on torch tensors (counterpart of paddle_tpu/ops/); importing
this package registers every ported op."""

from . import (activation, conv_ops, elementwise, fused_ops,  # noqa: F401
               loss, matmul, nn_ops, norm_ops, optimizer_ops, reduce,
               rnn_ops, sequence_ops, tensor_ops)
