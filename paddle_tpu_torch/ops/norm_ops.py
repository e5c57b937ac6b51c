"""batch_norm and its grad (counterpart of paddle_tpu/ops/norm_ops.py
:118, with ``bn_forward_math`` :71 and ``bn_backward_math`` :144), and the
layer_norm forward and its grad (reference :193 ``_ln_compute``, :223
grad maker, :235, :248), and lrn and its grad (reference :294).

``bn_forward_math`` and ``bn_backward_math`` are shared with
fused_conv2d_bn's plain route (ops/fused_ops.py), so a fused program and the
unfused conv2d/batch_norm/relu chain agree bitwise under
``kernel_tier=torch``. Statistics are float32 for float32, bfloat16 and
float16 activations and float64 for float64 ones (the reference computes
those in float32 too); the output returns in the activation dtype.
"""

from __future__ import annotations

import torch

from ..core.flags import get_flag
from ..core.registry import (register_op, infer_output, same_shape,
                             OpSpec, G)
from .common import data_of, vjp


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


def _wide(x):
    """x in the dtype batch norm computes in: float32, or float64 where x
    is float64."""
    return x if x.dtype == torch.float64 else x.float()


def bn_forward_math(x, scale, bias, running_mean, running_var, eps,
                    momentum, layout, is_test):
    """The batch_norm forward. Returns (y, new_mean, new_var, saved_mean,
    saved_var). In training the batch statistics are float32 (float64 for
    float64 activations): the centered two-pass variance for float32 and
    float64 activations, the single-pass
    E[x²]−E[x]² (clamped at 0) for bfloat16 ones, as the reference
    (:93-110); the running statistics blend as
    ``momentum·running + (1−momentum)·batch``."""
    axes = _bn_axes(x, layout)
    bshape = _bn_bshape(x, layout)
    if is_test:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    else:
        xf = _wide(x)
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
    y = (_wide(x) * (scale * inv_std).reshape(bshape)
         + (bias - mean * scale * inv_std).reshape(bshape))
    return y.to(x.dtype), new_mean, new_var, mean, var


def _fusion_barrier(side):
    """Whether the reference's conv/statistics fusion barrier is asked for
    on ``side`` ("fwd" or "bwd"): ``bn_fusion_barrier`` OR the one-sided
    flag (reference :130, :179)."""
    return get_flag("bn_fusion_barrier") or get_flag(
        "bn_fusion_barrier_" + side)


def optimization_barrier(x):
    """The identity. The reference's ``lax.optimization_barrier`` stops XLA
    fusing batch_norm's reductions into the conv that produces their
    input; an eager op loop fuses nothing across ops, so there is nothing
    to stop and the outputs are bitwise those without the barrier."""
    return x


@register_op("batch_norm", infer_shape=_bn_infer, grad=_bn_grad_maker)
def batch_norm(ctx):
    x = ctx.input("X")
    if _fusion_barrier("fwd"):
        x = optimization_barrier(x)
    y, new_mean, new_var, mean, var = bn_forward_math(
        x, ctx.input("Scale"), ctx.input("Bias"),
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
    float32 (float64 for float64 activations). Returns (dx, dscale,
    dbias); dx in x's dtype."""
    axes = _bn_axes(x, layout)
    bshape = _bn_bshape(x, layout)
    m = x.numel() // x.shape[_bn_channel_axis(x, layout)]
    xf, dyf = _wide(x), _wide(dy)
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
    x, dy = ctx.input("X"), ctx.input("Y@GRAD")
    if _fusion_barrier("bwd"):
        x, dy = optimization_barrier(x), optimization_barrier(dy)
    dx, dscale, dbias = bn_backward_math(
        x, ctx.input("Scale"), ctx.input("SavedMean"),
        ctx.input("SavedVariance"), dy,
        ctx.attr("epsilon", 1e-5), ctx.attr("data_layout", "NCHW"),
        bool(ctx.attr("is_test", False)))
    ctx.set_output("X@GRAD", dx)
    ctx.set_output("Scale@GRAD", dscale)
    ctx.set_output("Bias@GRAD", dbias)


def _ln_compute(x, scale, bias, begin_norm_axis, eps):
    """layer_norm over the dims from ``begin_norm_axis`` on: the biased
    variance, ``(x - mean) * rsqrt(var + eps)``, then the scale and the
    bias. Returns (y, mean [lead], variance [lead])."""
    shape = x.shape
    lead = 1
    for s in shape[:begin_norm_axis]:
        lead *= s
    flat = x.reshape(lead, -1)
    mean = torch.mean(flat, dim=1, keepdim=True)
    var = torch.var(flat, dim=1, keepdim=True, correction=0)
    y = (flat - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.reshape(1, -1)
    if bias is not None:
        y = y + bias.reshape(1, -1)
    return y.reshape(shape), mean.reshape(lead), var.reshape(lead)


def _ln_infer(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        return
    lead = 1
    for s in x.shape[:op.attrs.get("begin_norm_axis", 1)]:
        lead *= s
    infer_output(op, block, "Y", x.shape, dtype=x.dtype)
    for slot in ("Mean", "Variance"):
        if op.output(slot):
            infer_output(op, block, slot, (lead,), dtype=x.dtype)


def _ln_grad_maker(op):
    """layer_norm_grad over X and dY, with the Scale and Bias slots (and
    their grads) only where the forward has them (reference :223)."""
    inputs = {"X": op.input("X"), "Y@GRAD": G(op.output("Y"))}
    outputs = {"X@GRAD": G(op.input("X"))}
    for slot in ("Scale", "Bias"):
        if op.input(slot):
            inputs[slot] = op.input(slot)
            outputs[slot + "@GRAD"] = G(op.input(slot))
    return [OpSpec("layer_norm_grad", inputs, outputs, dict(op.attrs))]


@register_op("layer_norm", infer_shape=_ln_infer, grad=_ln_grad_maker)
def layer_norm(ctx):
    x = data_of(ctx.input("X"))
    scale = data_of(ctx.input("Scale")) if ctx.has_input("Scale") else None
    bias = data_of(ctx.input("Bias")) if ctx.has_input("Bias") else None
    y, mean, var = _ln_compute(x, scale, bias,
                               ctx.attr("begin_norm_axis", 1),
                               ctx.attr("epsilon", 1e-5))
    ctx.set_output("Y", y)
    ctx.set_output("Mean", mean)
    ctx.set_output("Variance", var)


@register_op("layer_norm_grad")
def layer_norm_grad(ctx):
    """The vector-Jacobian product of ``_ln_compute``'s Y against Y@GRAD,
    for X and for each of Scale and Bias the forward was given (reference
    :248)."""
    x = data_of(ctx.input("X"))
    scale = data_of(ctx.input("Scale")) if ctx.has_input("Scale") else None
    bias = data_of(ctx.input("Bias")) if ctx.has_input("Bias") else None
    bna = ctx.attr("begin_norm_axis", 1)
    eps = ctx.attr("epsilon", 1e-5)
    primals = [t for t in (x, scale, bias) if t is not None]

    def f(a, *rest):
        rest = list(rest)
        s = rest.pop(0) if scale is not None else None
        b = rest.pop(0) if bias is not None else None
        return _ln_compute(a, s, b, bna, eps)[0]

    grads = list(vjp(f, primals, data_of(ctx.input("Y@GRAD"))))
    ctx.set_output("X@GRAD", grads.pop(0))
    if scale is not None:
        ctx.set_output("Scale@GRAD", grads.pop(0))
    if bias is not None:
        ctx.set_output("Bias@GRAD", grads.pop(0))


# ---------------------------------------------------------------------------
# lrn (cross-channel local response normalization)
# ---------------------------------------------------------------------------

def _lrn_compute(x, n, k, alpha, beta):
    """lrn_op.cc: MidOut = k + alpha * (the sum of x^2 over a window of
    ``n`` channels, centred), Out = x * MidOut^-beta."""
    sq = x * x
    half = n // 2
    padded = torch.nn.functional.pad(sq, (0, 0, 0, 0, half, n - 1 - half))
    windows = sum(padded[:, i:i + x.shape[1]] for i in range(n))
    mid = k + alpha * windows
    return x * mid ** (-beta), mid


def _lrn_args(ctx):
    return (int(ctx.attr("n", 5)), ctx.attr("k", 2.0),
            ctx.attr("alpha", 1e-4), ctx.attr("beta", 0.75))


@register_op("lrn", infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "lrn_grad",
                 {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
                 {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def lrn(ctx):
    out, mid = _lrn_compute(data_of(ctx.input("X")), *_lrn_args(ctx))
    ctx.set_output("Out", out)
    ctx.set_output("MidOut", mid)


@register_op("lrn_grad")
def lrn_grad(ctx):
    args = _lrn_args(ctx)
    ctx.set_output("X@GRAD", vjp(lambda a: _lrn_compute(a, *args)[0],
                                 [data_of(ctx.input("X"))],
                                 data_of(ctx.input("Out@GRAD")))[0])
