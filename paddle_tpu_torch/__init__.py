"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The JAX package (``paddle_tpu/``) is the reference; this package mirrors its
module layout (``core/``, ``fluid/``, ``ops/``, ``serving/``) so each module
has a counterpart at the same path. Plain tensor code is PyTorch; every
Pallas kernel on a ported path is a kernel written by hand for Hopper under
``csrc/``, bound through ``ops/cuda/``.

Entry points (``fluid.Executor``, ``serving.InferenceEngine``) run on
``cuda:0`` unless the caller passes ``fluid.CPUPlace()``.
"""

from . import fluid  # noqa: F401  (registers every op lowering)

__all__ = ["fluid"]
