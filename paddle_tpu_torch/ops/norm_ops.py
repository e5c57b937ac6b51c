"""batch_norm and its grad (counterpart of paddle_tpu/ops/norm_ops.py
:118, with ``bn_forward_math`` :71 and ``bn_backward_math`` :144).

``bn_forward_math`` and ``bn_backward_math`` are shared with
fused_conv2d_bn's plain route (ops/fused_ops.py), so a fused program and the
unfused conv2d/batch_norm/relu chain agree bitwise under
``kernel_tier=torch``. Statistics are float32 whatever the activation
dtype; the output returns in the activation dtype.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op, infer_output, OpSpec, G


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


def _bn_grad_maker(op):
    return [OpSpec("batch_norm_grad",
                   {"X": op.input("X"), "Scale": op.input("Scale"),
                    "SavedMean": op.output("SavedMean"),
                    "SavedVariance": op.output("SavedVariance"),
                    "Y@GRAD": G(op.output("Y"))},
                   {"X@GRAD": G(op.input("X")),
                    "Scale@GRAD": G(op.input("Scale")),
                    "Bias@GRAD": G(op.input("Bias"))},
                   dict(op.attrs))]


def _bn_channel_axis(x, layout):
    if layout == "NHWC":
        return x.ndim - 1
    if layout in (None, "NCHW", "AnyLayout"):
        return 1
    raise ValueError(f"batch_norm: unsupported data_layout {layout!r}")


def _bn_axes(x, layout):
    c = _bn_channel_axis(x, layout)
    return tuple(i for i in range(x.ndim) if i != c)


def _bn_bshape(x, layout):
    c = _bn_channel_axis(x, layout)
    return tuple(x.shape[c] if i == c else 1 for i in range(x.ndim))


def bn_forward_math(x, scale, bias, running_mean, running_var, eps,
                    momentum, layout, is_test):
    """The batch_norm forward. Returns (y, new_mean, new_var, saved_mean,
    saved_var). In training the batch statistics are float32: the centered
    two-pass variance for float32 activations, the single-pass
    E[x²]−E[x]² (clamped at 0) for bfloat16 ones, as the reference
    (:93-110); the running statistics blend as
    ``momentum·running + (1−momentum)·batch``."""
    axes = _bn_axes(x, layout)
    bshape = _bn_bshape(x, layout)
    if is_test:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    else:
        xf = x.float()
        mean = torch.mean(xf, dim=axes)
        if x.dtype == torch.bfloat16:
            var = torch.clamp_min(torch.mean(xf * xf, dim=axes)
                                  - mean * mean, 0.0)
        else:
            d = xf - mean.reshape(bshape)
            var = torch.mean(d * d, dim=axes)
        new_mean = momentum * running_mean + (1.0 - momentum) * mean
        new_var = momentum * running_var + (1.0 - momentum) * var
    inv_std = torch.rsqrt(var + eps)
    y = (x.float() * (scale * inv_std).reshape(bshape)
         + (bias - mean * scale * inv_std).reshape(bshape))
    return y.to(x.dtype), new_mean, new_var, mean, var


@register_op("batch_norm", infer_shape=_bn_infer, grad=_bn_grad_maker)
def batch_norm(ctx):
    y, new_mean, new_var, mean, var = bn_forward_math(
        ctx.input("X"), ctx.input("Scale"), ctx.input("Bias"),
        ctx.input("Mean"), ctx.input("Variance"), ctx.attr("epsilon", 1e-5),
        ctx.attr("momentum", 0.9), ctx.attr("data_layout", "NCHW"),
        bool(ctx.attr("is_test", False)))
    ctx.set_output("Y", y)
    ctx.set_output("MeanOut", new_mean)
    ctx.set_output("VarianceOut", new_var)
    ctx.set_output("SavedMean", mean)
    ctx.set_output("SavedVariance", var)


def bn_backward_math(x, scale, mean, var, dy, eps, layout, is_test):
    """The batch_norm_grad closed form over the saved statistics, in
    float32. Returns (dx, dscale, dbias); dx in x's dtype."""
    axes = _bn_axes(x, layout)
    bshape = _bn_bshape(x, layout)
    m = x.numel() // x.shape[_bn_channel_axis(x, layout)]
    xf, dyf = x.float(), dy.float()
    inv_std = torch.rsqrt(var + eps).reshape(bshape)
    xhat = (xf - mean.reshape(bshape)) * inv_std
    dbias = torch.sum(dyf, dim=axes)
    dscale = torch.sum(dyf * xhat, dim=axes)
    if is_test:
        dx = dyf * scale.reshape(bshape) * inv_std
    else:
        dx = (scale.reshape(bshape) * inv_std / m) * (
            m * dyf - dbias.reshape(bshape) - xhat * dscale.reshape(bshape))
    return dx.to(x.dtype), dscale, dbias


@register_op("batch_norm_grad")
def batch_norm_grad(ctx):
    dx, dscale, dbias = bn_backward_math(
        ctx.input("X"), ctx.input("Scale"), ctx.input("SavedMean"),
        ctx.input("SavedVariance"), ctx.input("Y@GRAD"),
        ctx.attr("epsilon", 1e-5), ctx.attr("data_layout", "NCHW"),
        bool(ctx.attr("is_test", False)))
    ctx.set_output("X@GRAD", dx)
    ctx.set_output("Scale@GRAD", dscale)
    ctx.set_output("Bias@GRAD", dbias)
