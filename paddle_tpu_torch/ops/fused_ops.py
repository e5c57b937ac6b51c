"""fused_conv2d_bn: the conv+batch_norm(+relu) chain as ONE op, and its
grad (counterpart of paddle_tpu/ops/fused_ops.py).

``fluid.fuse_conv_bn`` rewrites eligible conv2d→batch_norm(→relu) chains
into this op, and each lowering picks the route per dispatch:

* **kernel** — the variant ``ops/autotune.py``'s ``dispatch_variant``
  picks (a pinned variant, the engine's or the attached tuning table under
  ``kernel_tier=auto``, else the tier's static route) is ``pallas``: the
  tier wants the kernel and ``supported()`` admits the shape;
  ``pallas_db``: the same kernels on the 128-row tile (bitwise the same
  results); ``pallas_bf16``: x cast to bfloat16 before them and y cast
  back (reference :96-135). Inference folds ``a = scale·rsqrt(var+eps)``,
  ``b = bias − mean·a`` and runs ``conv_affine`` (reference :119-126);
  training runs ``conv_bn_train`` and blends the running statistics here
  (reference :127-133); the grad runs ``conv_bn_bwd``.
* **plain** — everything else: ``conv2d_compute`` + ``bn_forward_math`` +
  the relu, and for the grad the relu mask, ``bn_backward_math`` and
  ``conv2d_backward``: the same helpers the unfused conv2d, batch_norm and
  relu ops and their grads call (reference :137-143, :182-192), so a fused
  program agrees bitwise with the unfused one under ``kernel_tier=torch``.
  An unsupported shape under a kernel tier counts a fallback.

Under AMP x and w are cast to bfloat16 before the route is picked
(reference :89, :166), so the bfloat16 builds of the kernels run. The
kernel route hands the wrappers the float32 master filter, which they lay
out per tap in x's dtype, rounding to nearest even as the cast would: the
same bfloat16 filter without a cast and a bfloat16 copy of it per call.
Filter@GRAD is the kernel's float32 dw on the kernel route (reference
pallas/conv_bn.py:433) and, as in the reference's plain chain, the conv's
dw in the cast filter's bfloat16 on the plain one.

The op keeps batch_norm's output contract: MeanOut/VarianceOut carry the
running statistics (passed through in inference), SavedMean/SavedVariance
the batch statistics the grad reads.
"""

from __future__ import annotations

import torch

from ..core.amp import cast_compute
from ..core.registry import register_op, infer_output, OpSpec, G
from .conv_ops import (conv_attrs, conv_df, conv2d_compute, conv2d_backward,
                       conv2d_infer)
from .autotune import dispatch_variant, dtype_str, make_key
from .cuda import use_kernel
from .cuda import conv_bn as cbk
from .norm_ops import bn_forward_math, bn_backward_math


def _fused_conv_bn_infer(op, block):
    conv2d_infer(op, block)
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    if w.shape is None:
        return
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        if op.output(slot):
            infer_output(op, block, slot, (int(w.shape[0]),), dtype=x.dtype)


def _fused_conv_bn_grad_maker(op):
    return [OpSpec(
        "fused_conv2d_bn_grad",
        {"Input": op.input("Input"), "Filter": op.input("Filter"),
         "Scale": op.input("Scale"), "Bias": op.input("Bias"),
         "SavedMean": op.output("SavedMean"),
         "SavedVariance": op.output("SavedVariance"),
         "Output": op.output("Output"),
         "Output@GRAD": G(op.output("Output"))},
        {"Input@GRAD": G(op.input("Input")),
         "Filter@GRAD": G(op.input("Filter")),
         "Scale@GRAD": G(op.input("Scale")),
         "Bias@GRAD": G(op.input("Bias"))},
        dict(op.attrs))]


def _supported(x, w, strides, paddings, dilations, groups, df, dtype=None):
    return cbk.supported(tuple(x.shape), tuple(w.shape), strides, paddings,
                         dilations, groups, df, dtype or x.dtype)


@register_op("fused_conv2d_bn", infer_shape=_fused_conv_bn_infer,
             grad=_fused_conv_bn_grad_maker)
def fused_conv2d_bn(ctx):
    w = ctx.input("Filter")
    x, wc = cast_compute(ctx.input("Input"), w)
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    rm, rv = ctx.input("Mean"), ctx.input("Variance")
    strides, paddings, dilations, groups = conv_attrs(ctx.attr)
    df = conv_df(ctx.attr)
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    act = ctx.attr("act", "") or ""
    is_test = bool(ctx.attr("is_test", False))

    sup = _supported(x, w, strides, paddings, dilations, groups, df)
    key = make_key(x=tuple(x.shape), w=tuple(w.shape),
                   dtype=dtype_str(x.dtype),
                   strides=tuple(strides), paddings=tuple(paddings),
                   dilations=tuple(dilations), groups=groups, df=df,
                   act=act, is_test=is_test)
    choice = dispatch_variant("conv_bn", key, {
        "jnp": True,
        "pallas": sup,
        "pallas_db": sup and cbk.db_supported(
            tuple(x.shape), tuple(w.shape), strides, paddings, x.dtype,
            x.device),
        # bf16 activations (value-changing, tuner opt-in): only a cast
        # away from float32 is a distinct variant
        "pallas_bf16": (x.dtype == torch.float32 and _supported(
            x, w, strides, paddings, dilations, groups, df,
            dtype=torch.bfloat16)),
    }, device=x.device)
    if choice != "jnp":
        out_dtype = x.dtype
        # the tile goes by keyword, and only where it is not the default
        tile = {"tile": cbk.DB_TILE} if choice == "pallas_db" else {}
        if choice == "pallas_bf16":
            # the wrappers lay the float32 filter out per tap in x's dtype,
            # rounding to nearest even: the reference's w.astype(bf16)
            x = x.to(torch.bfloat16)
        x = x.contiguous()
        if is_test:
            a = scale.float() * torch.rsqrt(rv.float() + eps)
            b = bias.float() - rm.float() * a
            y = torch.ops.paddle_tpu_torch.conv_affine(
                x, w, a, b, [int(v) for v in strides],
                [int(v) for v in paddings], act, **tile)
            new_mean, new_var, sm, sv = rm, rv, rm, rv
        else:
            y, sm, sv = cbk.conv_bn_train(x, w, scale.float(), bias.float(),
                                          eps, strides, paddings, act,
                                          **tile)
            new_mean = momentum * rm + (1.0 - momentum) * sm
            new_var = momentum * rv + (1.0 - momentum) * sv
        if choice == "pallas_bf16":
            y = y.to(out_dtype)
    else:
        z = conv2d_compute(x, wc, strides, paddings, dilations, groups, df)
        y, new_mean, new_var, sm, sv = bn_forward_math(
            z, scale, bias, rm, rv, eps, momentum, df, is_test)
        if act == "relu":
            y = torch.clamp_min(y, 0)
    ctx.set_output("Output", y)
    ctx.set_output("MeanOut", new_mean)
    ctx.set_output("VarianceOut", new_var)
    ctx.set_output("SavedMean", sm)
    ctx.set_output("SavedVariance", sv)


@register_op("fused_conv2d_bn_grad")
def fused_conv2d_bn_grad(ctx):
    w = ctx.input("Filter")
    x, wc = cast_compute(ctx.input("Input"), w)
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    sm, sv = ctx.input("SavedMean"), ctx.input("SavedVariance")
    dy = ctx.input("Output@GRAD")
    strides, paddings, dilations, groups = conv_attrs(ctx.attr)
    df = conv_df(ctx.attr)
    eps = ctx.attr("epsilon", 1e-5)
    act = ctx.attr("act", "") or ""
    is_test = bool(ctx.attr("is_test", False))

    sup = not is_test and _supported(x, w, strides, paddings, dilations,
                                     groups, df)
    if use_kernel("conv_bn", sup, x.device):
        dx, dw, dscale, dbias = cbk.conv_bn_bwd(
            x.contiguous(), w, dy.to(x.dtype), scale.float(), bias.float(),
            sm.float(), sv.float(), eps, strides, paddings, act)
    else:
        # the unfused chain's backward: relu_grad, batch_norm_grad, then
        # conv2d_grad, on the conv output recomputed; dx comes back in the
        # compute dtype (the reference's cast_compute(dx), :193)
        if act == "relu":
            dy = dy * (ctx.input("Output") > 0)
        z = conv2d_compute(x, wc, strides, paddings, dilations, groups, df)
        dz, dscale, dbias = bn_backward_math(z, scale, sm, sv, dy, eps, df,
                                             is_test)
        dx, dw = conv2d_backward(x, wc, dz, strides, paddings, dilations,
                                 groups, df)
    ctx.set_output("Input@GRAD", dx)
    ctx.set_output("Filter@GRAD", dw)
    ctx.set_output("Scale@GRAD", dscale)
    ctx.set_output("Bias@GRAD", dbias)
