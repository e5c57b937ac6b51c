"""fused_conv2d_bn: the conv+batch_norm(+relu) chain as ONE op, in
inference mode (counterpart of paddle_tpu/ops/fused_ops.py:74).

``fluid.fuse_conv_bn`` rewrites eligible conv2d→batch_norm(→relu) chains
into this op, and its lowering picks the route per dispatch:

* **kernel** — the tier wants the kernel and ``supported()`` admits the
  shape: fold ``a = scale·rsqrt(var+eps)``, ``b = bias − mean·a`` and run
  ``ops.cuda.conv_bn.conv_affine`` (reference :119-126).
* **plain** — everything else: ``conv2d_compute`` + ``bn_forward_math`` +
  the relu, the same arithmetic as the unfused op chain (reference
  :137-143). An unsupported shape under a kernel tier counts a fallback.

The op keeps batch_norm's output contract: in inference mode MeanOut and
VarianceOut pass the running statistics through.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op, infer_output
from .conv_ops import conv_attrs, conv_df, conv2d_compute, conv2d_infer
from .cuda import use_kernel
from .cuda import conv_bn as cbk
from .norm_ops import bn_forward_math


def _fused_conv_bn_infer(op, block):
    conv2d_infer(op, block)
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    if w.shape is None:
        return
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        if op.output(slot):
            infer_output(op, block, slot, (int(w.shape[0]),), dtype=x.dtype)


@register_op("fused_conv2d_bn", infer_shape=_fused_conv_bn_infer)
def fused_conv2d_bn(ctx):
    x, w = ctx.input("Input"), ctx.input("Filter")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    rm, rv = ctx.input("Mean"), ctx.input("Variance")
    strides, paddings, dilations, groups = conv_attrs(ctx.attr)
    df = conv_df(ctx.attr)
    eps = ctx.attr("epsilon", 1e-5)
    act = ctx.attr("act", "") or ""
    is_test = bool(ctx.attr("is_test", False))
    if not is_test:
        raise NotImplementedError(
            "fused_conv2d_bn training mode is not ported yet; run an "
            "inference program (clone(for_test=True))")

    sup = cbk.supported(tuple(x.shape), tuple(w.shape), strides, paddings,
                        dilations, groups, df, x.dtype)
    if use_kernel("conv_bn", sup, x.device):
        a = scale.float() * torch.rsqrt(rv.float() + eps)
        b = bias.float() - rm.float() * a
        y = cbk.conv_affine(x.contiguous(), w, a, b, strides, paddings, act)
    else:
        z = conv2d_compute(x, w, strides, paddings, dilations, groups, df)
        y = bn_forward_math(z, scale, bias, rm, rv, eps, df, is_test)
        if act == "relu":
            y = torch.clamp_min(y, 0)
    ctx.set_output("Output", y)
    ctx.set_output("MeanOut", rm)
    ctx.set_output("VarianceOut", rv)
    ctx.set_output("SavedMean", rm)
    ctx.set_output("SavedVariance", rv)
