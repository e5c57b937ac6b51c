"""Op lowerings on torch tensors (counterpart of paddle_tpu/ops/); importing
this package registers every ported op."""

from . import (activation, conv_ops, elementwise, fused_ops,  # noqa: F401
               loss, matmul, norm_ops, optimizer_ops, reduce, tensor_ops)
