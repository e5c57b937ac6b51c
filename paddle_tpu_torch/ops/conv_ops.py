"""Convolution and pooling ops and their grads: conv2d, depthwise_conv2d,
conv2d_transpose and pool2d (counterpart of paddle_tpu/ops/conv_ops.py).

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

Under AMP the conv casts x and w to bfloat16 (reference :99) and cuDNN
accumulates in float32; Output and Input@GRAD come back in bfloat16
(reference :191-197, :210), Filter@GRAD in the filter's float32, the
optimizer's master gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.amp import cast_compute
from ..core.flags import get_flag
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


def _s2d_stem_eligible(x, w, strides, paddings, dilations, groups, df):
    """Whether the space-to-depth stem rewrite applies exactly (reference
    :35): an NHWC stride-2 ungrouped undilated conv over at most 4 input
    channels with a filter wider than 1 (the ResNet/VGG stem, 7x7/s2 over
    HxWx3), on even spatial dims."""
    return (df == "NHWC" and tuple(strides) == (2, 2)
            and tuple(dilations) == (1, 1) and groups == 1 and x.dim() == 4
            and x.shape[3] <= 4 and x.shape[1] % 2 == 0
            and x.shape[2] % 2 == 0 and w.shape[2] > 1 and w.shape[3] > 1)


def _s2d_geom(k, p, size):
    """One spatial dim of the rewrite: (taps of the stride-1 filter, its
    left and right padding, the offset of the filter in the (2Kh, 2Kw)
    grid)."""
    m_min = -((p + 1) // 2)
    m_max = (k - 1 - p) // 2
    out = (size + 2 * p - k) // 2 + 1
    return (m_max - m_min + 1, -m_min, out - 1 + m_max - (size // 2 - 1),
            2 * (-m_min) - p)


def _s2d_stem_conv(x, w, paddings):
    """conv2d(k, stride 2, pad) over NHWC ``x`` as a stride-1 conv over the
    2x2 space-to-depth transform of ``x`` (reference :50-86), or None when
    a padding of the rewrite comes out negative.

    y[i, j] = sum_{p, q, c} x[2i + p - ph, 2j + q - pw, c] W[o, c, p, q];
    writing each input row as u = 2(i + m) + a (block row i + m, parity a)
    gives p = 2m + a + ph, so the filter embeds in a zero-padded (2Kh, 2Kw)
    grid whose (parity, block) regrouping is the stride-1 filter over the
    (a, b, c)-packed channels."""
    n, h, wd, c = x.shape
    o, _, kh, kw = w.shape
    kh2, pl_h, pr_h, off_h = _s2d_geom(kh, paddings[0], h)
    kw2, pl_w, pr_w, off_w = _s2d_geom(kw, paddings[1], wd)
    if min(pl_h, pr_h, pl_w, pr_w) < 0:
        return None
    # x: [N, H, W, C] -> [N, H/2, 2, W/2, 2, C] -> [N, H/2, W/2, (a, b, c)]
    x2 = x.reshape(n, h // 2, 2, wd // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    x2 = x2.reshape(n, h // 2, wd // 2, 4 * c).permute(0, 3, 1, 2)
    # the filter at (off_h, off_w) in the (2Kh, 2Kw) grid, regrouped
    # [o, c, m, a, n, b] -> [o, (a, b, c), m, n]
    wp = F.pad(w.to(x.dtype), (off_w, 2 * kw2 - kw - off_w,
                               off_h, 2 * kh2 - kh - off_h))
    w2 = wp.reshape(o, c, kh2, 2, kw2, 2).permute(0, 3, 5, 1, 2, 4)
    w2 = w2.reshape(o, 4 * c, kh2, kw2)
    y = F.conv2d(F.pad(x2, (pl_w, pr_w, pl_h, pr_h)), w2)
    return y.permute(0, 2, 3, 1).contiguous()


def _use_s2d(x, w, strides, paddings, dilations, groups, df):
    """The conv_space_to_depth flag is on and the rewrite applies to this
    conv, its paddings included (reference :101-105)."""
    if not (get_flag("conv_space_to_depth") and _s2d_stem_eligible(
            x, w, strides, paddings, dilations, groups, df)):
        return False
    pads = [_s2d_geom(w.shape[2 + i], paddings[i], x.shape[1 + i])[1:3]
            for i in (0, 1)]
    return min(min(p) for p in pads) >= 0


def conv2d_compute(x, w, strides, paddings, dilations, groups, df="NCHW"):
    """conv2d at layout ``df`` (reference conv_ops.py:92), on bfloat16
    operands under AMP; an eligible stem conv through the space-to-depth
    rewrite under ``conv_space_to_depth``."""
    x, w = cast_compute(x, w)
    if _use_s2d(x, w, strides, paddings, dilations, groups, df):
        return _s2d_stem_conv(x, w, paddings)
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
    autograd would run first. dx comes back in the dtype the forward
    computed in (x's, or bfloat16 under AMP: the reference's
    ``cast_compute(dx)``), dw in w's."""
    xc, wc = cast_compute(x, w)
    if _use_s2d(xc, wc, strides, paddings, dilations, groups, df):
        # through the rewritten forward, as the reference's vjp of its
        # _conv2d_compute is
        dx, dw = vjp(lambda a, b: _s2d_stem_conv(a, b, paddings),
                     (xc, wc.to(xc.dtype)), dy)
        return dx, dw.to(w.dtype)
    if df == "NHWC":
        xc, dy = xc.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.to(xc.dtype), xc, wc.to(xc.dtype), None, list(strides),
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


def _grad_1x1_as_dot(x, w, dy):
    """(dx, dw) of an NHWC 1x1 stride-1 conv as channel products
    (reference :183-199): dx = dy·W in the compute dtype, dw = dyᵀ·x
    accumulated and returned in float32 (float64 for float64 tensors)."""
    xc, wc = cast_compute(x, w)
    dyc = dy.to(xc.dtype)
    w2 = wc.to(xc.dtype).reshape(wc.shape[0], wc.shape[1])     # [O, I]
    dx = torch.matmul(dyc, w2)
    acc = torch.promote_types(xc.dtype, torch.float32)
    dw = torch.matmul(dyc.reshape(-1, w2.shape[0]).to(acc).t(),
                      xc.reshape(-1, w2.shape[1]).to(acc))
    return cast_compute(dx), dw.reshape(w.shape)


@register_op("conv2d_grad")
def conv2d_grad(ctx):
    strides, paddings, dilations, groups = conv_attrs(ctx.attr)
    df = conv_df(ctx.attr)
    w = ctx.input("Filter")
    if (get_flag("conv_1x1_grad_as_dot") and df == "NHWC"
            and tuple(w.shape[2:]) == (1, 1) and strides == (1, 1)
            and paddings == (0, 0) and dilations == (1, 1) and groups == 1):
        dx, dw = _grad_1x1_as_dot(ctx.input("Input"), w,
                                  ctx.input("Output@GRAD"))
        ctx.set_output("Input@GRAD", dx)
        ctx.set_output("Filter@GRAD", dw)
        return
    dx, dw = conv2d_backward(ctx.input("Input"), w,
                             ctx.input("Output@GRAD"), strides, paddings,
                             dilations, groups, df)
    ctx.set_output("Input@GRAD", dx)
    ctx.set_output("Filter@GRAD", dw)


# ---------------------------------------------------------------------------
# depthwise_conv2d, conv2d_transpose
# ---------------------------------------------------------------------------

def _depthwise_grad_maker(op):
    spec = _conv2d_grad_maker(op)[0]
    spec.type = "depthwise_conv2d_grad"
    return [spec]


def _depthwise_args(ctx):
    """conv2d's attrs with one group per input channel (reference :220:
    conv_op.cc registers depthwise_conv2d as conv2d with groups =
    channels)."""
    strides, paddings, dilations, _ = conv_attrs(ctx.attr)
    df = conv_df(ctx.attr)
    x = ctx.input("Input")
    return strides, paddings, dilations, x.shape[3 if df == "NHWC" else 1], df


@register_op("depthwise_conv2d", infer_shape=conv2d_infer,
             grad=_depthwise_grad_maker)
def depthwise_conv2d(ctx):
    ctx.set_output("Output", conv2d_compute(
        ctx.input("Input"), ctx.input("Filter"), *_depthwise_args(ctx)))


@register_op("depthwise_conv2d_grad")
def depthwise_conv2d_grad(ctx):
    """dx in the forward's compute dtype (the reference's
    ``cast_compute(dx)``, :247), dw in the filter's."""
    dx, dw = conv2d_backward(ctx.input("Input"), ctx.input("Filter"),
                             ctx.input("Output@GRAD"), *_depthwise_args(ctx))
    ctx.set_output("Input@GRAD", dx)
    ctx.set_output("Filter@GRAD", dw)


def conv2d_transpose_compute(x, w, strides, paddings, dilations):
    """conv_transpose_op.cc: the gradient of conv2d with respect to its
    input, the filter [C_in, C_out, kh, kw]; an output of (H - 1)·stride -
    2·pad + dilation·(k - 1) + 1. bfloat16 operands under AMP (reference
    :264)."""
    x, w = cast_compute(x, w)
    return F.conv_transpose2d(x, w.to(x.dtype), stride=strides,
                              padding=paddings, dilation=dilations)


def _conv2d_transpose_infer(op, block):
    x = block.var(op.input("Input")[0])
    w = block.var(op.input("Filter")[0])
    if x.shape is None or w.shape is None:
        return
    s = _pair(op.attrs.get("strides", [1, 1]))
    p = _pair(op.attrs.get("paddings", [0, 0]))
    d = _pair(op.attrs.get("dilations", [1, 1]))
    n, _, h, wd = x.shape
    _, m, kh, kw = w.shape
    ho = (h - 1) * s[0] - 2 * p[0] + (d[0] * (kh - 1) + 1)
    wo = (wd - 1) * s[1] - 2 * p[1] + (d[1] * (kw - 1) + 1)
    infer_output(op, block, "Output", (n, m, ho, wo), dtype=x.dtype)


@register_op("conv2d_transpose", infer_shape=_conv2d_transpose_infer,
             grad=lambda op: [OpSpec(
                 "conv2d_transpose_grad",
                 {"Input": op.input("Input"), "Filter": op.input("Filter"),
                  "Output@GRAD": G(op.output("Output"))},
                 {"Input@GRAD": G(op.input("Input")),
                  "Filter@GRAD": G(op.input("Filter"))},
                 dict(op.attrs))])
def conv2d_transpose(ctx):
    strides, paddings, dilations, _ = conv_attrs(ctx.attr)
    ctx.set_output("Output", conv2d_transpose_compute(
        ctx.input("Input"), ctx.input("Filter"), strides, paddings,
        dilations))


@register_op("conv2d_transpose_grad")
def conv2d_transpose_grad(ctx):
    """dx in the compute dtype (reference :317), dw in the filter's."""
    strides, paddings, dilations, _ = conv_attrs(ctx.attr)
    w = ctx.input("Filter")
    dx, dw = vjp(lambda a, b: conv2d_transpose_compute(
        a, b, strides, paddings, dilations), (ctx.input("Input"), w),
        ctx.input("Output@GRAD"))
    ctx.set_output("Input@GRAD", cast_compute(dx))
    ctx.set_output("Filter@GRAD", dw.to(w.dtype))


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
