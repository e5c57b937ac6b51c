"""Automatic mixed precision: bfloat16 compute with float32 master weights
(counterpart of paddle_tpu/core/amp.py).

The casts sit at the op sites, as in the reference, and nowhere else:

* the GEMM ops (``mul``, ``conv2d``, ``fused_conv2d_bn``) cast their
  float32 operands to bfloat16 with :func:`cast_compute` and accumulate in
  float32;
* the loss ops compute in float32 (:func:`upcast_f32`), and batch_norm
  keeps its statistics in float32;
* the optimizer ops cast a bfloat16 gradient up to the parameter's dtype,
  so parameters, optimizer state and running statistics never leave
  float32.

There is no ``torch.autocast``: an op outside those sites computes in the
dtype its inputs arrive in, with PyTorch's type promotion (a bfloat16 GEMM
output plus a float32 bias is float32, as in the reference's jnp).

Turn it on per executor (``fluid.Executor(amp=True)``, which runs its op
loop under :func:`amp_guard`) or lexically with ``fluid.amp_guard()``. The
state is a context variable, not a process global: each thread (a serving
worker, a training loop beside it) sees only the setting of the executor it
runs, and a new thread starts with AMP off.

A bfloat16 GEMM on the card accumulates in float32 only while
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
off (with it on, cuBLAS may reduce split-K partials in bfloat16). This
module turns it off once, when it is imported: that is the reference's
``preferred_element_type=float32``, and no float32 GEMM reads the switch.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar

import torch

torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

# (enabled, compute dtype) of the running context
_state = ContextVar("paddle_tpu_torch_amp", default=(False, torch.bfloat16))

_LOW = (torch.bfloat16, torch.float16)
_HIGH = (torch.float32, torch.float64)


def amp_enabled():
    return _state.get()[0]


def amp_dtype():
    return _state.get()[1]


def _resolve(dtype):
    if dtype is None:
        return amp_dtype()
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def set_amp(enabled, dtype=None):
    """Set the running context's state; returns the previous (enabled,
    dtype)."""
    prev = _state.get()
    _state.set((bool(enabled), _resolve(dtype)))
    return prev


@contextmanager
def amp_guard(enabled=True, dtype="bfloat16"):
    token = _state.set((bool(enabled), _resolve(dtype)))
    try:
        yield
    finally:
        _state.reset(token)


def _apply(arrays, cast):
    out = tuple(cast(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def cast_compute(*arrays):
    """Cast float32/float64 tensors to the compute dtype when AMP is on;
    anything else, and everything when it is off, passes through."""
    enabled, ct = _state.get()
    if not enabled:
        return arrays if len(arrays) > 1 else arrays[0]
    return _apply(arrays, lambda a: a.to(ct) if isinstance(
        a, torch.Tensor) and a.dtype in _HIGH else a)


def upcast_f32(*arrays):
    """Cast low-precision float tensors up to float32 (the stability
    islands: losses, softmax, norm statistics)."""
    return _apply(arrays, lambda a: a.float() if isinstance(
        a, torch.Tensor) and a.dtype in _LOW else a)


__all__ = ["amp_enabled", "amp_dtype", "set_amp", "amp_guard",
           "cast_compute", "upcast_f32"]
