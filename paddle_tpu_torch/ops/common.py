"""Shared helpers for op lowerings and grad makers (counterpart of
paddle_tpu/ops/common.py)."""

from __future__ import annotations

import torch


def collapse_to(v, target_shape, lead_axis):
    """Sum ``v`` down to ``target_shape``, which was broadcast into it
    starting at ``lead_axis``: the gradient of the elementwise broadcast
    rule (reference common.py ``collapse_to``)."""
    ynd = len(target_shape)
    axes = tuple(range(lead_axis)) + tuple(range(lead_axis + ynd, v.ndim))
    if axes:
        v = torch.sum(v, dim=axes)
    inner = tuple(i for i, s in enumerate(target_shape)
                  if s == 1 and v.shape[i] != 1)
    if inner:
        v = torch.sum(v, dim=inner, keepdim=True)
    return v.reshape(tuple(target_shape))


def vjp(fn, primals, cotangent):
    """The vector-Jacobian product of ``fn`` at ``primals`` against
    ``cotangent`` (the reference's ``jax.vjp`` calls), through autograd,
    which is enabled here only: the executor's op loop runs under
    ``torch.no_grad()``. The cotangent is cast to the output's dtype."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in primals]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, cotangent.to(out.dtype))
