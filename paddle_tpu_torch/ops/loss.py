"""Classification ops (counterpart of paddle_tpu/ops/loss.py): softmax
over the last axis (reference :22)."""

from __future__ import annotations

import torch

from ..core.registry import register_op, same_shape


@register_op("softmax", infer_shape=same_shape("X", "Out"))
def softmax(ctx):
    ctx.set_output("Out", torch.softmax(ctx.input("X"), dim=-1))
