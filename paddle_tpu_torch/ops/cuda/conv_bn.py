"""Fused conv + folded batch-norm inference kernel (counterpart of
paddle_tpu/ops/pallas/conv_bn.py::conv_affine_pallas).

``conv_affine`` computes ``y = act(round(conv(x, w)) * a + b)`` over NHWC
``x`` and an OIHW filter, with ``a = scale·rsqrt(var+eps)`` and
``b = bias − mean·a`` folded by the caller and ``round`` rounding the float32
conv sum to x's dtype. On a CUDA tensor it launches the kernel in
``csrc/conv_affine.cu``; on a CPU tensor it runs :func:`conv_affine_torch`,
the plain version of the same arithmetic.

``supported()`` keeps the reference's structural conditions and drops its
TPU VMEM budget: NHWC, groups 1, no dilation, 1x1 or 3x3 at stride 1, or 1x1
at stride 2 with no padding, float32 or bfloat16. On ResNet-50 that admits
the same 49 of 53 conv+bn chains as the reference.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...core.types import torch_dtype
from . import build as _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset; only a launch adds to it
launches = 0


def reset_launches():
    global launches
    launches = 0


def supported(x_shape, w_shape, strides, paddings, dilations, groups,
              data_format, x_dtype):
    """Can the kernel run this conv shape? ``x_dtype`` is a torch dtype or
    a dtype name."""
    if data_format != "NHWC" or groups != 1:
        return False
    if tuple(dilations) != (1, 1):
        return False
    if len(x_shape) != 4 or any(d is None or int(d) < 0 for d in x_shape):
        return False
    kh, kw = int(w_shape[2]), int(w_shape[3])
    if (kh, kw) not in ((1, 1), (3, 3)) or int(w_shape[1]) != int(x_shape[3]):
        return False
    s = tuple(int(v) for v in strides)
    if s == (2, 2):
        if (kh, kw) != (1, 1) or tuple(paddings) != (0, 0):
            return False
    elif s != (1, 1):
        return False
    if torch_dtype(x_dtype) not in _DTYPE_CODES:
        return False
    ho, wo = _out_hw(x_shape, kh, kw, s[0], paddings)
    return ho > 0 and wo > 0


def _out_hw(x_shape, kh, kw, stride, paddings):
    h, w = int(x_shape[1]), int(x_shape[2])
    ph, pw = (int(p) for p in paddings)
    return ((h + 2 * ph - kh) // stride + 1, (w + 2 * pw - kw) // stride + 1)


def conv_affine_torch(x, w, a, b, strides, paddings, act):
    """Plain PyTorch version: per-tap matmuls accumulated in float32 (the
    reference's ``_conv_taps``, conv_bn.py:122), the conv sum rounded to x's
    dtype, then ``z*a + b`` in float32, the relu, and a cast to x's dtype."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    if tuple(strides) == (2, 2):
        x = x[:, ::2, ::2, :]
    ph, pw = (int(p) for p in paddings)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    n, hp, wp, cin = x.shape
    cout = w.shape[0]
    ho, wo = hp - kh + 1, wp - kw + 1
    wt = w.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout).to(x.dtype).float()
    xf = x.float()
    acc = None
    for i in range(kh):
        for j in range(kw):
            part = xf[:, i:i + ho, j:j + wo, :].reshape(n * ho * wo, cin) \
                @ wt[i * kw + j]
            acc = part if acc is None else acc + part
    y = acc.to(x.dtype).float() * a.float() + b.float()
    if act == "relu":
        y = torch.clamp_min(y, 0)
    return y.to(x.dtype).reshape(n, ho, wo, cout)


def conv_affine(x, w, a, b, strides, paddings, act):
    """The fused conv+affine(+relu). CPU tensors run the plain version; CUDA
    tensors launch the kernel, and anything the kernel does not take
    raises."""
    global launches
    if x.device.type == "cpu":
        return conv_affine_torch(x, w, a, b, strides, paddings, act)
    if act not in ("", "relu"):
        raise ValueError(f"conv_affine: unsupported act {act!r}")
    if not supported(tuple(x.shape), tuple(w.shape), strides, paddings,
                     (1, 1), 1, "NHWC", x.dtype):
        raise ValueError(
            f"conv_affine: unsupported shape x{tuple(x.shape)} "
            f"w{tuple(w.shape)} strides={strides} paddings={paddings} "
            f"dtype={x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv_affine: x must be a contiguous NHWC tensor")
    n, h, wd, cin = x.shape
    cout, _, kh, kw = w.shape
    for name, t in (("w", w), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"conv_affine: {name} is on {t.device}, x on "
                             f"{x.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32 \
            or a.shape != (cout,) or b.shape != (cout,):
        raise ValueError("conv_affine: a and b must be float32 [Cout]")
    a, b = a.contiguous(), b.contiguous()
    wt = w.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout) \
        .to(x.dtype).contiguous()
    stride = int(strides[0])
    ho, wo = _out_hw(x.shape, kh, kw, stride, paddings)
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.conv_affine(
            x.data_ptr(), wt.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), _DTYPE_CODES[x.dtype], n, h, wd, cin, cout, kh, kw,
            stride, int(paddings[0]), int(paddings[1]), ho, wo,
            int(act == "relu"), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"conv_affine launch failed: CUDA error {err} "
            f"({lib.conv_affine_error_string(err).decode()})")
    launches += 1
    return y


def _lib():
    lib = _build.load("conv_affine")
    if lib.conv_affine.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_affine.argtypes = [p, p, p, p, p] + [i] * 14 + [p]
        lib.conv_affine.restype = i
        lib.conv_affine_error_string.argtypes = [i]
        lib.conv_affine_error_string.restype = ctypes.c_char_p
    return lib
