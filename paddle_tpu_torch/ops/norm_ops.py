"""batch_norm in inference mode (counterpart of paddle_tpu/ops/norm_ops.py
:118, with ``bn_forward_math`` :71).

Only the ``is_test`` branch is ported: serving programs are pruned with
``clone(for_test=True)``, which sets it on every op. Training statistics
come with the training slice.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op, infer_output


def _bn_infer(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        return
    layout = op.attrs.get("data_layout", "NCHW")
    c = x.shape[-1] if layout == "NHWC" else x.shape[1]
    infer_output(op, block, "Y", x.shape, dtype=x.dtype)
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        if op.output(slot):
            infer_output(op, block, slot, (c,), dtype=x.dtype)


def _bn_bshape(x, layout):
    if layout == "NHWC":
        c = x.ndim - 1
    elif layout in (None, "NCHW", "AnyLayout"):
        c = 1
    else:
        raise ValueError(f"batch_norm: unsupported data_layout {layout!r}")
    return tuple(x.shape[c] if i == c else 1 for i in range(x.ndim))


def bn_forward_math(x, scale, bias, running_mean, running_var, eps, layout,
                    is_test):
    """y = x·(scale·rsqrt(var+eps)) + (bias − mean·scale·rsqrt(var+eps)),
    computed in float32 and stored in x's dtype — the reference's
    inference-mode formula, shared with fused_conv2d_bn's plain route."""
    if not is_test:
        raise NotImplementedError(
            "batch_norm training statistics are not ported yet; run an "
            "inference program (clone(for_test=True))")
    bshape = _bn_bshape(x, layout)
    inv_std = torch.rsqrt(running_var + eps)
    y = (x.float() * (scale * inv_std).reshape(bshape)
         + (bias - running_mean * scale * inv_std).reshape(bshape))
    return y.to(x.dtype)


@register_op("batch_norm", infer_shape=_bn_infer)
def batch_norm(ctx):
    rm, rv = ctx.input("Mean"), ctx.input("Variance")
    ctx.set_output("Y", bn_forward_math(
        ctx.input("X"), ctx.input("Scale"), ctx.input("Bias"), rm, rv,
        ctx.attr("epsilon", 1e-5), ctx.attr("data_layout", "NCHW"),
        bool(ctx.attr("is_test", False))))
    ctx.set_output("MeanOut", rm)
    ctx.set_output("VarianceOut", rv)
    ctx.set_output("SavedMean", rm)
    ctx.set_output("SavedVariance", rv)
