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
kernels do. ``w`` is the OIHW filter in float32 or in x's dtype: the
kernels lay it out per tap in x's dtype, rounding a float32 filter to
nearest even as a cast would, so under AMP the float32 master filter and
its bfloat16 cast give the same launch. On a CUDA tensor a wrapper
launches its kernel; on a CPU tensor it runs its plain version
(``*_torch``), the same arithmetic.

The tuner's variants of the reference's ``conv_bn`` (``ops/autotune.py``):
``pallas`` is these kernels on ``pick_tile``'s tile; ``pallas_db`` (the
reference's ``block_n=2``) passes ``tile=DB_TILE``, the 128-row tile where
``pick_tile`` takes 64 rows (:func:`db_supported`), bitwise the default's
output and statistics; ``pallas_bf16`` casts float32 x and w to bfloat16
before the same kernels and y back, in ``ops/fused_ops.py``.

``supported()`` keeps the reference's structural conditions and drops its
TPU VMEM budget: NHWC, groups 1, no dilation, 1x1 or 3x3 at stride 1, or 1x1
at stride 2 with no padding, float32 or bfloat16. On ResNet-50 that admits
the same 49 of 53 conv+bn chains as the reference, in both directions.

The inference op calls ``conv_affine`` as the ``torch.library`` operator
``torch.ops.paddle_tpu_torch.conv_affine`` (:func:`conv_affine_op`), so
that ``torch.export`` keeps the launch in an exported graph
(``fluid/aot.py``).
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ...core.types import torch_dtype
from . import build as _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, by wrapper and x's dtype:
# {wrapper: {"float32": n, "bfloat16": n}}; only a launch adds. A launch on
# the 128-row tile (``tile=DB_TILE``, the tuner's "pallas_db" variant)
# counts under ``<wrapper>_db``
launches_by_dtype = {"conv_affine": {}, "conv_bn_train": {},
                     "conv_bn_bwd": {}, "conv_affine_db": {},
                     "conv_bn_train_db": {}}

# the tile argument of the two-image variant: the 128-row tile where
# pick_tile (csrc/conv_mma.cuh) takes 64 rows
DB_TILE = 128


class _Totals(Mapping):
    """``launches[wrapper]``: its launches in every dtype, read from
    ``launches_by_dtype``."""

    def __getitem__(self, name):
        return sum(launches_by_dtype[name].values())

    def __iter__(self):
        return iter(launches_by_dtype)

    def __len__(self):
        return len(launches_by_dtype)


launches = _Totals()


def reset_launches():
    for by in launches_by_dtype.values():
        by.clear()


def _count(name, dtype, tile=0):
    by = launches_by_dtype[name + ("_db" if tile else "")]
    key = str(dtype).removeprefix("torch.")
    by[key] = by.get(key, 0) + 1


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
    if len(x_shape) != 4 or any(d is None or d < 0 for d in x_shape):
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


def db_supported(x_shape, w_shape, strides, paddings, x_dtype,
                 device="cuda"):
    """Is the two-image variant (``tile=DB_TILE``) offered here: where
    ``supported()`` holds and, on a card, the kernel library's ``db_ok``
    (csrc/conv_mma.cuh) finds that it runs another tile than the
    default's, the reference's ``_fused_supported(..., block_n=2)``
    counterpart. On a CPU tensor the variant runs the plain version, which
    has no tile, so it is offered wherever ``supported()`` holds. Under
    ``kernel_tier=torch`` and for a symbolic batch (a ``torch.export``
    trace, whose tile would depend on the batch) it is not offered."""
    if not supported(x_shape, w_shape, strides, paddings, (1, 1), 1, "NHWC",
                     x_dtype):
        return False
    from . import resolve_tier
    device = torch.device(device)
    if device.type != "cuda":
        return True
    # no kernel runs on the plain tier; a symbolic batch keys no tile
    if resolve_tier(device) != "cuda" or \
            not all(isinstance(d, int) for d in x_shape):
        return False
    kh, kw = int(w_shape[2]), int(w_shape[3])
    ho, wo = _out_hw(x_shape, kh, kw, int(strides[0]), paddings)
    lib = _build.load("conv_affine")
    fn = lib.conv_db_ok
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I] * 6, _I
    return bool(fn(_DTYPE_CODES[torch_dtype(x_dtype)], int(x_shape[0]), ho,
                   wo, int(w_shape[1]), int(w_shape[0])))


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


def _check_tile(name, tile):
    # where the 128-row tile is the default's, the C entry refuses it
    if tile not in (0, DB_TILE):
        raise ValueError(f"{name}: tile must be 0 or {DB_TILE}, got {tile}")


def conv_affine(x, w, a, b, strides, paddings, act, tile=0):
    """The fused conv+affine(+relu). CPU tensors run the plain version; CUDA
    tensors launch the kernel, and anything the kernel does not take
    raises. ``tile=DB_TILE`` runs the 128-row tile (where
    :func:`db_supported`); its output is bitwise the default's."""
    if x.device.type == "cpu":
        return conv_affine_torch(x, w, a, b, strides, paddings, act)
    _check("conv_affine", x, w, strides, paddings, act, {"a": a, "b": b})
    _check_tile("conv_affine", tile)
    a, b = a.contiguous(), b.contiguous()
    x, w32 = _aligned(x), _filter32(w)
    g = _geometry(x, w, strides, paddings)
    n, cin, cout, kh, kw, ho, wo = g[0], g[3], g[4], g[5], g[6], g[10], g[11]
    lib = _lib("conv_affine")
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    # scratch: the filter in the kernel's layout
    wt, _keep = _scratch(x.dtype, x.device, kh * kw * cin * cout)
    err = _build.call_on(
        x.device, lib.conv_affine, x.data_ptr(), w32.data_ptr(), wt,
        a.data_ptr(), b.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype], *g,
        int(act == "relu"), int(tile))
    _raise_on(lib, "conv_affine", err)
    _count("conv_affine", x.dtype, tile)
    return y


@torch.library.custom_op("paddle_tpu_torch::conv_affine", mutates_args=())
def conv_affine_op(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, strides: list[int], paddings: list[int],
                   act: str, tile: int = 0) -> torch.Tensor:
    """``torch.ops.paddle_tpu_torch.conv_affine``: :func:`conv_affine` as
    an operator that ``torch.export`` keeps whole in a graph, so that an
    exported inference program (``fluid/aot.py``) still launches the
    kernel. On CUDA tensors it launches the kernel, on CPU tensors it runs
    the plain version (the wrapper's own dispatch); its fake
    implementation gives the output's shape."""
    return conv_affine(x, w, a, b, strides, paddings, act,
                       **({"tile": tile} if tile else {}))


@conv_affine_op.register_fake
def _conv_affine_fake(x, w, a, b, strides, paddings, act, tile=0):
    ho, wo = _out_hw(x.shape, int(w.shape[2]), int(w.shape[3]),
                     int(strides[0]), paddings)
    return x.new_empty((x.shape[0], ho, wo, w.shape[0]))


@register_flop_formula(torch.ops.paddle_tpu_torch.conv_affine)
def _conv_affine_flops(x_shape, w_shape, *args, out_shape=None, **kwargs):
    """FlopCounterMode's count of the operator (obs.perf.attribute): the
    conv's multiply-adds, two operations each, as aten.convolution counts
    them; the affine epilogue is not counted, as batch_norm is not."""
    n, ho, wo, cout = (int(d) for d in out_shape)
    cin, kh, kw = int(w_shape[1]), int(w_shape[2]), int(w_shape[3])
    return 2 * n * ho * wo * cout * cin * kh * kw


def conv_bn_train(x, w, scale, bias, eps, strides, paddings, act, tile=0):
    """Training-mode conv + batch statistics + normalize (+relu). Returns
    ``(y, mean, var)``: y in x's dtype, the batch mean and biased variance
    float32 [Cout]. CPU tensors run the plain version; CUDA tensors launch
    the kernel, and anything the kernel does not take raises.
    ``tile=DB_TILE`` runs the 128-row tile (where :func:`db_supported`),
    whose y and statistics are bitwise the default's: it sums each half
    of its tile as a 64-row statistics block, in the 64-row tile's order."""
    if x.device.type == "cpu":
        return conv_bn_train_torch(x, w, scale, bias, eps, strides,
                                   paddings, act)
    _check("conv_bn_train", x, w, strides, paddings, act,
           {"scale": scale, "bias": bias})
    _check_tile("conv_bn_train", tile)
    scale, bias = scale.contiguous(), bias.contiguous()
    x, w32 = _aligned(x), _filter32(w)
    g = _geometry(x, w, strides, paddings)
    n, cin, cout, kh, kw, ho, wo = g[0], g[3], g[4], g[5], g[6], g[10], g[11]
    lib = _lib("conv_bn_train")
    (part_n,) = _scratch_sizes("conv_bn_train", _DTYPE_CODES[x.dtype],
                               tuple(g))
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    # scratch: the filter in the kernels' layout, and per-block partial
    # statistics + the folded affine
    wt, _keep_t = _scratch(x.dtype, x.device, kh * kw * cin * cout)
    (part, ab), _keep_f = _scratch(torch.float32, x.device, part_n,
                                   2 * cout)
    err = _build.call_on(
        x.device, lib.conv_bn_train, x.data_ptr(), w32.data_ptr(), wt,
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), part,
        stats.data_ptr(), ab, _DTYPE_CODES[x.dtype], *g,
        int(act == "relu"), ctypes.c_float(eps), int(tile))
    _raise_on(lib, "conv_bn_train", err)
    _count("conv_bn_train", x.dtype, tile)
    return y, stats[0], stats[1]


@functools.lru_cache(maxsize=1024)
def _scratch_sizes(name, dtype_code, g, *extra):
    """The float32 scratch sizes (in elements) that the C entry ``name``
    needs for geometry ``g``: its ``<name>_scratch`` function says, from the
    tile it picks (csrc/conv_mma.cuh)."""
    fn = getattr(_lib(name), f"{name}_scratch")
    sizes = (ctypes.c_longlong * 2)()
    err = fn(dtype_code, *g, *extra, ctypes.addressof(sizes))
    if err != 0:
        raise ValueError(f"{name}: no scratch plan for geometry {g} "
                         f"{extra} (error {err})")
    return tuple(sizes[:_SCRATCH_PARTS[name]])


def _filter32(w):
    """The OIHW filter as contiguous float32, the C entries' input (they
    lay it out per tap in x's dtype themselves)."""
    if w.dtype == torch.float32 and w.is_contiguous():
        return w
    return w.float().contiguous()


def _scratch(dtype, device, *sizes):
    """One buffer of ``dtype`` holding ``sizes`` elements in turn, each
    part starting on 16 bytes. Returns (the parts' addresses, the buffer,
    which the caller keeps until its launches are enqueued); a single size
    gives its address alone."""
    item = 2 if dtype == torch.bfloat16 else 4
    step = 16 // item
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // step) * step
    buf = torch.empty(total, dtype=dtype, device=device)
    ptrs = [buf.data_ptr() + o * item for o in offs]
    return (ptrs[0] if len(ptrs) == 1 else ptrs), buf


def _aligned(t):
    """``t``, or a copy where its data does not start on 16 bytes: the
    kernels copy 16 bytes at a time where the channel counts allow it."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    x, dy, w32 = _aligned(x), _aligned(dy.contiguous()), _filter32(w)
    scale, bias, mean, var = (t.contiguous() for t in (scale, bias, mean,
                                                        var))
    lib = _lib("conv_bn_bwd")
    m = n * ho * wo
    taps = kh * kw
    sms = _sm_count(x.device)
    part_n, dw_part_n = _scratch_sizes("conv_bn_bwd", _DTYPE_CODES[x.dtype],
                                       tuple(g), sms)
    f32 = dict(dtype=torch.float32, device=x.device)
    grads = torch.empty((2, cout), **f32)     # dscale, dbias
    dw = torch.empty((cout, cin, kh, kw), **f32)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # scratch: the filter per tap (the conv's B), rotated and transposed
    # per tap (dx's B) and z, later dz, in x's dtype; a, b, inv and
    # scale·inv/m per channel, per-block partial sums and dw's per-range
    # partials in float32
    (wt, wrot, zbuf), _keep_t = _scratch(x.dtype, x.device,
                                         taps * cin * cout, taps * cin * cout,
                                         m * cout)
    (aux, part, dw_part), _keep_f = _scratch(
        torch.float32, x.device, 4 * cout, part_n, dw_part_n)
    err = _build.call_on(
        x.device, lib.conv_bn_bwd, x.data_ptr(), w32.data_ptr(), wt, wrot,
        dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        var.data_ptr(), zbuf, aux, part, grads.data_ptr(), dw_part,
        dw.data_ptr(), dx.data_ptr(), _DTYPE_CODES[x.dtype], *g,
        int(act == "relu"), ctypes.c_float(eps), sms)
    _raise_on(lib, "conv_bn_bwd", err)
    _count("conv_bn_bwd", x.dtype)
    return dx, dw, grads[0], grads[1]


@functools.lru_cache(maxsize=None)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


# C signatures: pointers, then the dtype code, the 12 geometry ints and the
# relu flag, then conv_affine's tile, conv_bn_train's eps and tile,
# conv_bn_bwd's eps and SM count, then the stream; the training kernels'
# scratch functions take the dtype code, the geometry, the SM count (the
# backward) and an array for the sizes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "conv_affine": [_P] * 6 + [_I] * 15 + [_P],
    "conv_bn_train": [_P] * 9 + [_I] * 14 + [_F, _I, _P],
    "conv_bn_bwd": [_P] * 16 + [_I] * 14 + [_F, _I, _P],
    "conv_bn_train_scratch": [_I] * 13 + [_P],
    "conv_bn_bwd_scratch": [_I] * 14 + [_P],
}
# how many sizes each scratch function writes
_SCRATCH_PARTS = {"conv_bn_train": 1, "conv_bn_bwd": 2}


def _lib(name):
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        if name in _SCRATCH_PARTS:
            scratch = getattr(lib, f"{name}_scratch")
            scratch.argtypes = _ARGTYPES[f"{name}_scratch"]
            scratch.restype = _I
        lib.kernel_error_string.argtypes = [_I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
