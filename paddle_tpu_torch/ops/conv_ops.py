"""Convolution and pooling ops and their grads (counterpart of
paddle_tpu/ops/conv_ops.py).

A conv is ``torch.nn.functional.conv2d`` at the program's layout: NHWC
tensors are viewed as channels-last NCHW, so no copy is made on the way in
or out. The filter is OIHW in both layouts. Pooling keeps the reference's
geometry exactly: max pads with -inf, avg is exclusive of padding, and a
ceil-mode output gets the reference's extra bottom/right padding.

The grads are vector-Jacobian products of those same forwards, as the
reference's are ``jax.vjp`` of its forwards (reference :175, :473): the
conv's through autograd's conv backward, the pool's through autograd. A max
pool sends each window's gradient to the window's first maximum, which is
also what the reference's default ``select_and_scatter`` lowering does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op, infer_output, OpSpec, G
from .common import vjp


def _pair(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def conv_attrs(attr):
    strides = _pair(attr("strides", [1, 1]))
    paddings = _pair(attr("paddings", [0, 0]))
    dilations = _pair(attr("dilations", [1, 1]))
    groups = int(attr("groups", 1) or 1)
    return strides, paddings, dilations, groups


def conv_df(attr):
    return attr("data_format", "NCHW") or "NCHW"


def conv2d_compute(x, w, strides, paddings, dilations, groups, df="NCHW"):
    """conv2d at layout ``df`` (reference conv_ops.py:92)."""
    if df == "NHWC":
        y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=strides,
                     padding=paddings, dilation=dilations, groups=groups)
        return y.permute(0, 2, 3, 1).contiguous()
    return F.conv2d(x, w.to(x.dtype), stride=strides, padding=paddings,
                    dilation=dilations, groups=groups)


def _conv_out_size(h, k, pad, stride, dilation=1):
    return (h + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def conv2d_infer(op, block):
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    if x.shape is None or w.shape is None:
        return
    s = _pair(op.attrs.get("strides", [1, 1]))
    p = _pair(op.attrs.get("paddings", [0, 0]))
    d = _pair(op.attrs.get("dilations", [1, 1]))
    df = op.attrs.get("data_format", "NCHW") or "NCHW"
    if df == "NHWC":
        n, h, wd, _ = x.shape
    else:
        n, _, h, wd = x.shape
    m, _, kh, kw = w.shape
    oh = _conv_out_size(h, kh, p[0], s[0], d[0])
    ow = _conv_out_size(wd, kw, p[1], s[1], d[1])
    shape = (n, oh, ow, m) if df == "NHWC" else (n, m, oh, ow)
    infer_output(op, block, "Output", shape, dtype=x.dtype)


def conv2d_backward(x, w, dy, strides, paddings, dilations, groups,
                    df="NCHW"):
    """(dx, dw) of :func:`conv2d_compute` against ``dy`` (the reference's
    ``jax.vjp`` of its conv): the conv2d_grad op's arithmetic, shared with
    fused_conv2d_bn's plain route so the fused and unfused programs agree
    bitwise. It is autograd's own conv backward, called without the forward
    autograd would run first. dx comes back in x's dtype, dw in w's."""
    if df == "NHWC":
        x, dy = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.to(x.dtype), x, w.to(x.dtype), None, list(strides),
        list(paddings), list(dilations), False, [0, 0], groups,
        [True, True, False])
    if df == "NHWC":
        dx = dx.permute(0, 2, 3, 1).contiguous()
    return dx, dw.to(w.dtype)


def _conv2d_grad_maker(op):
    return [OpSpec("conv2d_grad",
                   {"Input": op.input("Input"), "Filter": op.input("Filter"),
                    "Output@GRAD": G(op.output("Output"))},
                   {"Input@GRAD": G(op.input("Input")),
                    "Filter@GRAD": G(op.input("Filter"))},
                   dict(op.attrs))]


@register_op("conv2d", infer_shape=conv2d_infer, grad=_conv2d_grad_maker)
def conv2d(ctx):
    strides, paddings, dilations, groups = conv_attrs(ctx.attr)
    ctx.set_output("Output", conv2d_compute(
        ctx.input("Input"), ctx.input("Filter"), strides, paddings,
        dilations, groups, conv_df(ctx.attr)))


@register_op("conv2d_grad")
def conv2d_grad(ctx):
    strides, paddings, dilations, groups = conv_attrs(ctx.attr)
    dx, dw = conv2d_backward(ctx.input("Input"), ctx.input("Filter"),
                             ctx.input("Output@GRAD"), strides, paddings,
                             dilations, groups, conv_df(ctx.attr))
    ctx.set_output("Input@GRAD", dx)
    ctx.set_output("Filter@GRAD", dw)


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------

def _pool_geometry(h, w, ksize, strides, paddings, global_pooling,
                   ceil_mode):
    """Effective ksize/paddings, output dims, and the extra bottom/right
    padding that makes the window grid cover a ceil-mode output (reference
    conv_ops.py _pool_geometry)."""
    if global_pooling:
        ksize = (h, w)
        paddings = (0, 0)
    kh, kw = ksize
    ph, pw = paddings
    sh, sw = strides

    def out_dim(size, k, p, s):
        if ceil_mode:
            return -((size - k + 2 * p) // -s) + 1
        return (size - k + 2 * p) // s + 1

    oh, ow = out_dim(h, kh, ph, sh), out_dim(w, kw, pw, sw)
    eh = max(0, (oh - 1) * sh + kh - h - 2 * ph)
    ew = max(0, (ow - 1) * sw + kw - w - 2 * pw)
    return (kh, kw), (ph, pw), (sh, sw), (oh, ow), (eh, ew)


def pool2d_compute(x, ksize, strides, paddings, pooling_type, global_pooling,
                   ceil_mode, exclusive=True, df="NCHW"):
    """pool2d at layout ``df`` (reference conv_ops.py:353)."""
    xc = x.permute(0, 3, 1, 2) if df == "NHWC" else x
    h, w = xc.shape[2], xc.shape[3]
    (kh, kw), (ph, pw), (sh, sw), _, (eh, ew) = _pool_geometry(
        h, w, ksize, strides, paddings, global_pooling, ceil_mode)
    pads = (pw, pw + ew, ph, ph + eh)
    if pooling_type == "max":
        xp = F.pad(xc, pads, value=float("-inf")) if any(pads) else xc
        y = F.max_pool2d(xp, (kh, kw), (sh, sw))
    else:
        xp = F.pad(xc, pads) if any(pads) else xc
        sums = F.avg_pool2d(xp, (kh, kw), (sh, sw), divisor_override=1)
        if exclusive and any(pads):
            ones = F.pad(torch.ones((1, 1, h, w), dtype=x.dtype,
                                    device=x.device), pads)
            y = sums / F.avg_pool2d(ones, (kh, kw), (sh, sw),
                                    divisor_override=1)
        else:
            y = sums / (kh * kw)
    return y.permute(0, 2, 3, 1).contiguous() if df == "NHWC" else y


def _pool2d_attrs(attr):
    return (_pair(attr("ksize", [2, 2])), _pair(attr("strides", [1, 1])),
            _pair(attr("paddings", [0, 0])), attr("pooling_type", "max"),
            bool(attr("global_pooling", False)),
            bool(attr("ceil_mode", False)), bool(attr("exclusive", True)),
            conv_df(attr))


def _pool2d_infer(op, block):
    x = block.var(op.input("X")[0])
    if x.shape is None:
        return
    k = _pair(op.attrs.get("ksize", [2, 2]))
    s = _pair(op.attrs.get("strides", [1, 1]))
    p = _pair(op.attrs.get("paddings", [0, 0]))
    ceil = bool(op.attrs.get("ceil_mode", False))
    df = op.attrs.get("data_format", "NCHW") or "NCHW"
    if df == "NHWC":
        n, h, w, c = x.shape
    else:
        n, c, h, w = x.shape
    if op.attrs.get("global_pooling", False):
        oh = ow = 1
    else:
        def od(size, kk, pp, ss):
            return (-((size - kk + 2 * pp) // -ss) + 1) if ceil else \
                ((size - kk + 2 * pp) // ss + 1)
        oh, ow = od(h, k[0], p[0], s[0]), od(w, k[1], p[1], s[1])
    shape = (n, oh, ow, c) if df == "NHWC" else (n, c, oh, ow)
    infer_output(op, block, "Out", shape, dtype=x.dtype)


@register_op("pool2d", infer_shape=_pool2d_infer, grad=lambda op: [OpSpec(
    "pool2d_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def pool2d(ctx):
    ctx.set_output("Out", pool2d_compute(ctx.input("X"),
                                         *_pool2d_attrs(ctx.attr)))


@register_op("pool2d_grad")
def pool2d_grad(ctx):
    args = _pool2d_attrs(ctx.attr)
    dx, = vjp(lambda a: pool2d_compute(a, *args), (ctx.input("X"),),
              ctx.input("Out@GRAD"))
    ctx.set_output("X@GRAD", dx)
