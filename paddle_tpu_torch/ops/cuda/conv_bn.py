"""Fused conv + batch-norm kernels (counterpart of
paddle_tpu/ops/pallas/conv_bn.py): three wrappers, each beside its plain
PyTorch version.

* ``conv_affine`` (inference, ``conv_affine_pallas``):
  ``y = act(round(conv(x, w))·a + b)`` with ``a = scale·rsqrt(var+eps)``,
  ``b = bias − mean·a`` folded by the caller; ``csrc/conv_affine.cu``.
* ``conv_bn_train`` (training forward, ``conv_bn_train_pallas``): the conv,
  the batch mean and biased variance of its output, the normalize and the
  relu; returns ``(y, mean, var)``; ``csrc/conv_bn_train.cu``.
* ``conv_bn_bwd`` (training backward, ``conv_bn_bwd_pallas``): from x, w,
  dy and the saved statistics, the relu mask of the recomputed conv, dbias,
  dscale, the BN input-gradient dz, dw (float32, OIHW) and dx (x's dtype);
  returns ``(dx, dw, dscale, dbias)``; ``csrc/conv_bn_bwd.cu``.

``round`` rounds the float32 conv sum to x's dtype, as the reference's
kernels do. On a CUDA tensor a wrapper launches its kernel; on a CPU tensor
it runs its plain version (``*_torch``), the same arithmetic.

``supported()`` keeps the reference's structural conditions and drops its
TPU VMEM budget: NHWC, groups 1, no dilation, 1x1 or 3x3 at stride 1, or 1x1
at stride 2 with no padding, float32 or bfloat16. On ResNet-50 that admits
the same 49 of 53 conv+bn chains as the reference, in both directions.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...core.types import torch_dtype
from . import build as _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per wrapper since the last reset; only a launch adds
launches = {"conv_affine": 0, "conv_bn_train": 0, "conv_bn_bwd": 0}

# the kernels' implicit-GEMM tile (csrc/conv_tile.cuh: BM pixels per block)
_BM = 64


def reset_launches():
    for k in launches:
        launches[k] = 0


def supported(x_shape, w_shape, strides, paddings, dilations, groups,
              data_format, x_dtype):
    """Can the kernels run this conv shape? ``x_dtype`` is a torch dtype or
    a dtype name. The forward and the backward take the same shapes, so
    unlike the reference (whose backward has its own VMEM budget) there is
    no ``backward`` argument."""
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


def _conv_taps_torch(x, w, strides, paddings):
    """The conv as per-tap matmuls accumulated in float32 (the reference's
    ``_conv_taps``, conv_bn.py:122). Returns (acc [M, Cout] float32,
    (n, ho, wo), the subsampled and padded input)."""
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
    return acc, (n, ho, wo), x


def conv_affine_torch(x, w, a, b, strides, paddings, act):
    """Plain PyTorch version: the per-tap conv sum rounded to x's dtype,
    then ``z*a + b`` in float32, the relu, and a cast to x's dtype."""
    acc, (n, ho, wo), _ = _conv_taps_torch(x, w, strides, paddings)
    y = acc.to(x.dtype).float() * a.float() + b.float()
    if act == "relu":
        y = torch.clamp_min(y, 0)
    return y.to(x.dtype).reshape(n, ho, wo, w.shape[0])


def _fold(scale, bias, mean, var, eps):
    """(a, b, inv): the folded BN affine of the saved statistics."""
    inv = torch.rsqrt(var.float() + eps)
    a = scale.float() * inv
    return a, bias.float() - mean.float() * a, inv


def conv_bn_train_torch(x, w, scale, bias, eps, strides, paddings, act):
    """Plain PyTorch version of :func:`conv_bn_train`: the per-tap conv
    rounded to x's dtype, its float32 batch mean and biased two-pass
    variance per channel, ``z·a + b`` with ``a = scale·rsqrt(var+eps)``,
    ``b = bias − mean·a``, the relu, and a cast to x's dtype."""
    acc, (n, ho, wo), _ = _conv_taps_torch(x, w, strides, paddings)
    z = acc.to(x.dtype).float()
    mean = z.mean(0)
    d = z - mean
    var = (d * d).mean(0)
    a, b, _ = _fold(scale, bias, mean, var, eps)
    y = z * a + b
    if act == "relu":
        y = torch.clamp_min(y, 0)
    return y.to(x.dtype).reshape(n, ho, wo, w.shape[0]), mean, var


def conv_bn_bwd_torch(x, w, dy, scale, bias, mean, var, eps, strides,
                      paddings, act):
    """Plain PyTorch version of :func:`conv_bn_bwd` (the reference's
    ``_conv_bn_bwd_kernel``): recompute z, mask dy by ``z·a+b > 0`` under a
    relu, ``dbias = Σdy'``, ``dscale = Σdy'·x̂``, ``dz = (scale·inv/m)·
    (m·dy' − dbias − x̂·dscale)`` rounded to x's dtype, then per tap
    ``dw = x_tapᵀ·dz`` and dx as the transpose of the tap gathers, both
    accumulated in float32. A stride-2 1x1 scatters dx to the even
    positions."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    cin, cout = int(w.shape[1]), int(w.shape[0])
    acc, (n, ho, wo), xp = _conv_taps_torch(x, w, strides, paddings)
    m = n * ho * wo
    z = acc.to(x.dtype).float()
    a, b, inv = _fold(scale, bias, mean, var, eps)
    dyf = dy.reshape(m, cout).float()
    if act == "relu":
        dyf = dyf * ((z * a + b) > 0)
    xhat = (z - mean.float()) * inv
    dbias = dyf.sum(0)
    dscale = (dyf * xhat).sum(0)
    dz = (scale.float() * inv / m) * (m * dyf - dbias - xhat * dscale)
    dzf = dz.to(x.dtype).float()
    wt = w.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout).to(x.dtype).float()
    xpf = xp.float()
    dxp = torch.zeros(xp.shape, dtype=torch.float32, device=x.device)
    dw = torch.empty((kh * kw, cin, cout), dtype=torch.float32,
                     device=x.device)
    for i in range(kh):
        for j in range(kw):
            t = i * kw + j
            dw[t] = xpf[:, i:i + ho, j:j + wo, :].reshape(m, cin).T @ dzf
            dxp[:, i:i + ho, j:j + wo, :] += \
                (dzf @ wt[t].T).reshape(n, ho, wo, cin)
    ph, pw = (int(p) for p in paddings)
    dxs = dxp[:, ph:xp.shape[1] - ph, pw:xp.shape[2] - pw, :].to(x.dtype)
    if tuple(strides) == (2, 2):
        dx = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        dx[:, ::2, ::2, :] = dxs
    else:
        dx = dxs.contiguous()
    dw = dw.reshape(kh, kw, cin, cout).permute(3, 2, 0, 1).contiguous()
    return dx, dw, dscale, dbias


def _check(name, x, w, strides, paddings, act, vectors):
    """The checks every kernel wrapper makes before its launch."""
    if act not in ("", "relu"):
        raise ValueError(f"{name}: unsupported act {act!r}")
    if not supported(tuple(x.shape), tuple(w.shape), strides, paddings,
                     (1, 1), 1, "NHWC", x.dtype):
        raise ValueError(
            f"{name}: unsupported shape x{tuple(x.shape)} "
            f"w{tuple(w.shape)} strides={strides} paddings={paddings} "
            f"dtype={x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    cout = w.shape[0]
    for vname, t in [("w", w)] + list(vectors.items()):
        if t.device != x.device:
            raise ValueError(f"{name}: {vname} is on {t.device}, x on "
                             f"{x.device}")
    for vname, t in vectors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,):
            raise ValueError(f"{name}: {vname} must be float32 [Cout]")


def _taps(w, dtype):
    """OIHW -> [kh*kw, Cin, Cout] in ``dtype``: the kernels' B operand."""
    cout, cin, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout) \
        .to(dtype).contiguous()


def _geometry(x, w, strides, paddings):
    n, h, wd, cin = (int(d) for d in x.shape)
    cout, _, kh, kw = (int(d) for d in w.shape)
    stride = int(strides[0])
    ho, wo = _out_hw(x.shape, kh, kw, stride, paddings)
    return [n, h, wd, cin, cout, kh, kw, stride, int(paddings[0]),
            int(paddings[1]), ho, wo]


def _raise_on(lib, name, err):
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.kernel_error_string(err).decode()})")


def conv_affine(x, w, a, b, strides, paddings, act):
    """The fused conv+affine(+relu). CPU tensors run the plain version; CUDA
    tensors launch the kernel, and anything the kernel does not take
    raises."""
    if x.device.type == "cpu":
        return conv_affine_torch(x, w, a, b, strides, paddings, act)
    _check("conv_affine", x, w, strides, paddings, act, {"a": a, "b": b})
    a, b = a.contiguous(), b.contiguous()
    wt = _taps(w, x.dtype)
    g = _geometry(x, w, strides, paddings)
    y = torch.empty((g[0], g[10], g[11], g[4]), dtype=x.dtype,
                    device=x.device)
    lib = _lib("conv_affine")
    with torch.cuda.device(x.device):
        err = lib.conv_affine(
            x.data_ptr(), wt.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), _DTYPE_CODES[x.dtype], *g, int(act == "relu"),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "conv_affine", err)
    launches["conv_affine"] += 1
    return y


def conv_bn_train(x, w, scale, bias, eps, strides, paddings, act):
    """Training-mode conv + batch statistics + normalize (+relu). Returns
    ``(y, mean, var)``: y in x's dtype, the batch mean and biased variance
    float32 [Cout]. CPU tensors run the plain version; CUDA tensors launch
    the kernel, and anything the kernel does not take raises."""
    if x.device.type == "cpu":
        return conv_bn_train_torch(x, w, scale, bias, eps, strides,
                                   paddings, act)
    _check("conv_bn_train", x, w, strides, paddings, act,
           {"scale": scale, "bias": bias})
    scale, bias = scale.contiguous(), bias.contiguous()
    wt = _taps(w, x.dtype)
    g = _geometry(x, w, strides, paddings)
    n, cout, ho, wo = g[0], g[4], g[10], g[11]
    blocks_m = -(-(n * ho * wo) // _BM)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    part = torch.empty((2, blocks_m, cout), **f32)
    stats = torch.empty((2, cout), **f32)   # mean, var
    ab = torch.empty((2, cout), **f32)      # the folded affine
    lib = _lib("conv_bn_train")
    with torch.cuda.device(x.device):
        err = lib.conv_bn_train(
            x.data_ptr(), wt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), part.data_ptr(), stats.data_ptr(), ab.data_ptr(),
            _DTYPE_CODES[x.dtype], *g, int(act == "relu"),
            ctypes.c_float(eps), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "conv_bn_train", err)
    launches["conv_bn_train"] += 1
    return y, stats[0], stats[1]


def _dw_splits(tiles, m, sms):
    """How many pixel ranges the dw GEMM splits its K = N·Ho·Wo reduction
    into: enough blocks for two per SM, each range at least 16 pixels."""
    return max(1, min(-(-2 * sms // tiles), -(-m // 256)))


def conv_bn_bwd(x, w, dy, scale, bias, mean, var, eps, strides, paddings,
                act):
    """Training-mode backward of :func:`conv_bn_train`. Returns
    ``(dx, dw, dscale, dbias)``: dx in x's dtype, dw float32 OIHW, dscale
    and dbias float32 [Cout]. ``dy`` is in x's dtype. CPU tensors run the
    plain version; CUDA tensors launch the kernel, and anything the kernel
    does not take raises."""
    if x.device.type == "cpu":
        return conv_bn_bwd_torch(x, w, dy, scale, bias, mean, var, eps,
                                 strides, paddings, act)
    _check("conv_bn_bwd", x, w, strides, paddings, act,
           {"scale": scale, "bias": bias, "mean": mean, "var": var})
    g = _geometry(x, w, strides, paddings)
    n, cin, cout, kh, kw, ho, wo = g[0], g[3], g[4], g[5], g[6], g[10], g[11]
    if n * max(g[1] * g[2], ho * wo) >= 2 ** 31:
        raise ValueError("conv_bn_bwd: the dw GEMM indexes pixels in 32 "
                         "bits; N*H*W must stay below 2^31")
    if dy.dtype != x.dtype or tuple(dy.shape) != (n, ho, wo, cout) \
            or dy.device != x.device:
        raise ValueError(f"conv_bn_bwd: dy must be {x.dtype} "
                         f"[{n}, {ho}, {wo}, {cout}] on {x.device}")
    dy = dy.contiguous()
    scale, bias, mean, var = (t.contiguous() for t in (scale, bias, mean,
                                                        var))
    wt = _taps(w, x.dtype)
    # dx is the conv of dz with the filter rotated 180° and transposed per
    # tap: [kh*kw, Cout, Cin] with tap (r, s) holding w[:, :, kh-1-r, kw-1-s]
    wrot = w.flip(2, 3).permute(2, 3, 0, 1).reshape(kh * kw, cout, cin) \
        .to(x.dtype).contiguous()
    lib = _lib("conv_bn_bwd")
    m = n * ho * wo
    blocks_m = -(-m // _BM)
    taps = kh * kw
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = _dw_splits(taps * -(-cin // _BM) * -(-cout // _BM), m, sms)
    f32 = dict(dtype=torch.float32, device=x.device)
    zbuf = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    aux = torch.empty((4, cout), **f32)       # a, b, inv, scale·inv/m
    part = torch.empty((2, blocks_m, cout), **f32)
    grads = torch.empty((2, cout), **f32)     # dscale, dbias
    dw_part = torch.empty((splits, taps, cin, cout), **f32)
    dw = torch.empty((cout, cin, kh, kw), **f32)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.conv_bn_bwd(
            x.data_ptr(), wt.data_ptr(), wrot.data_ptr(), dy.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            var.data_ptr(), zbuf.data_ptr(), aux.data_ptr(),
            part.data_ptr(), grads.data_ptr(), dw_part.data_ptr(),
            dw.data_ptr(), dx.data_ptr(), _DTYPE_CODES[x.dtype], *g,
            int(act == "relu"), ctypes.c_float(eps), splits,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "conv_bn_bwd", err)
    launches["conv_bn_bwd"] += 1
    return dx, dw, grads[0], grads[1]


# C signatures: pointers, then the dtype code, the 12 geometry ints and the
# relu flag, then (for the training kernels) eps and extras, then the stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "conv_affine": [_P] * 5 + [_I] * 14 + [_P],
    "conv_bn_train": [_P] * 8 + [_I] * 14 + [_F, _P],
    "conv_bn_bwd": [_P] * 15 + [_I] * 14 + [_F, _I, _P],
}


def _lib(name):
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
