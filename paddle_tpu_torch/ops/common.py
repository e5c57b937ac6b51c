"""Shared helpers for op lowerings and grad makers (counterpart of
paddle_tpu/ops/common.py)."""

from __future__ import annotations

import torch

from ..core.lod import LoDArray


def data_of(v):
    """A LoDArray's padded data, any other value as it is: what a
    LoD-transparent op computes on (reference common.py ``data_of``)."""
    return v.data if isinstance(v, LoDArray) else v


def like(ref, value):
    """``value`` with ``ref``'s lengths when ``ref`` is a LoDArray, else
    ``value`` (reference common.py ``like``)."""
    return LoDArray(value, ref.lens) if isinstance(ref, LoDArray) else value


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
    ``torch.no_grad()``. ``fn`` returns one tensor or a tuple of them, and
    ``cotangent`` matches; each cotangent is cast to its output's dtype."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in primals]
        out = fn(*leaves)
        if isinstance(out, tuple):
            return torch.autograd.grad(
                out, leaves, [c.to(o.dtype) for o, c in zip(out, cotangent)])
        return torch.autograd.grad(out, leaves, cotangent.to(out.dtype))
