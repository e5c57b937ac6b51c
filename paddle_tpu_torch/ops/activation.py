"""Activation ops (counterpart of paddle_tpu/ops/activation.py): relu,
the one activation ResNet serving runs (reference :60)."""

from __future__ import annotations

import torch

from ..core.registry import register_op, same_shape


@register_op("relu", infer_shape=same_shape("X", "Out"))
def relu(ctx):
    ctx.set_output("Out", torch.clamp_min(ctx.input("X"), 0))
