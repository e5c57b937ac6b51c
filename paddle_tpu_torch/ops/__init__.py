"""Op lowerings on torch tensors (counterpart of paddle_tpu/ops/); importing
this package registers every ported op."""

from . import (activation, attention_ops, breadth_ops,  # noqa: F401
               control_flow_ops, conv_ops, crf_ops, ctc_ops, detection_ops,
               elementwise, fused_ops, io_ops, loss, matmul, metrics,
               misc_ops, nn_ops, norm_ops, optimizer_ops, reduce, rnn_ops,
               sequence_ops, tensor_ops)
