"""How far the conv kernels and their plain versions each lie from the
exact result: conv_affine (y), conv_bn_train (y, mean, var) and
conv_bn_bwd (dx, dw, dscale, dbias) against a float64 computation of the
same function.

    python3 conv_bn_accuracy.py

Run from the root of a checkout on a machine with a card; a measurement
tool beside chip_smoke.py, not part of the port's package. The shapes are
tests/test_torch_conv_bn_train.py's card test (Cin 40, Cout 72, 12x12,
batch 3, seed 2, its three geometries; conv_affine takes scale and bias
as its a and b) and four ResNet-50 layers at batch
32. Per shape and output it prints max |got - exact| for the kernel and
the plain version, max |exact|, and for each the worst ratio
|got - exact| / (atol + rtol·|exact|) under the card test's float32
tolerance (atol 1e-5, rtol 2e-4): 1 or less means every element is within
it.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.cuda import conv_bn as cbk

EPS = 1e-5
ATOL, RTOL = 1e-5, 2e-4
# (name, N, H=W, Cin, Cout, k, stride, pad)
SHAPES = [("test 1x1", 3, 12, 40, 72, 1, 1, 0),
          ("test 3x3", 3, 12, 40, 72, 3, 1, 1),
          ("test 1x1/2", 3, 12, 40, 72, 1, 2, 0),
          ("res2 3x3 64", 32, 56, 64, 64, 3, 1, 1),
          ("res3 1x1/2 256->512", 32, 56, 256, 512, 1, 2, 0),
          ("res4 1x1 1024->256", 32, 14, 1024, 256, 1, 1, 0),
          ("res5 3x3 512", 32, 7, 512, 512, 3, 1, 1)]


def operands(n, hw, cin, cout, k, stride, pad, seed):
    """The card test's operands (tests/test_torch_conv_bn_train.py
    ``_operands``): x, w, scale, bias, dy as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, hw, hw, cin)).astype("float32")
    w = (rng.normal(0, 1, (cout, cin, k, k))
         * (2.0 / (cin * k * k)) ** 0.5).astype("float32")
    scale = rng.uniform(0.5, 1.5, cout).astype("float32")
    bias = rng.normal(0, 0.1, cout).astype("float32")
    ho = (hw + 2 * pad - k) // stride + 1
    dy = rng.normal(0, 1, (n, ho, ho, cout)).astype("float32")
    return x, w, scale, bias, dy


def exact(x, w, scale, bias, dy, mean, var, stride, pad):
    """float64: conv_affine's y = conv(x, w) * scale + bias, the forward
    (y without a relu, the batch mean and biased variance) and the
    backward at the given (mean, var), no relu."""
    x, w, dy = x.double(), w.double(), dy.double()
    xn = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    wn = w.detach().requires_grad_(True)
    with torch.enable_grad():
        zn = F.conv2d(xn, wn, stride=stride, padding=pad)
    z = zn.detach().permute(0, 2, 3, 1)
    m = z.shape[0] * z.shape[1] * z.shape[2]
    z2 = z.reshape(m, -1)
    fmean, fvar = z2.mean(0), z2.var(0, unbiased=False)
    y = (z2 - fmean) * (scale.double() * torch.rsqrt(fvar + EPS)) \
        + bias.double()
    inv = torch.rsqrt(var.double() + EPS)
    xh = (z2 - mean.double()) * inv
    d = dy.reshape(m, -1)
    db, ds = d.sum(0), (d * xh).sum(0)
    dz = (scale.double() * inv / m) * (m * d - db - xh * ds)
    gx, gw = torch.autograd.grad(zn, (xn, wn),
                                 dz.reshape(z.shape).permute(0, 3, 1, 2))
    affine = z * scale.double() + bias.double()
    return ((affine,), (y.reshape(z.shape), fmean, fvar),
            (gx.permute(0, 2, 3, 1), gw, ds, db))


def reading(got, ref):
    d = (got.double() - ref).abs()
    return d.max().item(), (d / (ATOL + RTOL * ref.abs())).max().item()


def main():
    if not torch.cuda.is_available():
        print("conv_bn_accuracy: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    print("shape | output | kernel max|err| worst/tol | plain max|err| "
          "worst/tol | max|exact|")
    dev = torch.device("cuda", 0)
    for name, n, hw, cin, cout, k, stride, pad in SHAPES:
        x, w, scale, bias, dy = (torch.from_numpy(a).to(dev) for a in
                                 operands(n, hw, cin, cout, k, stride, pad,
                                          seed=2))
        st, pd = (stride, stride), (pad, pad)
        aff_k = (cbk.conv_affine(x, w, scale, bias, st, pd, ""),)
        aff_p = (cbk.conv_affine_torch(x, w, scale, bias, st, pd, ""),)
        fwd_k = cbk.conv_bn_train(x, w, scale, bias, EPS, st, pd, "")
        fwd_p = cbk.conv_bn_train_torch(x, w, scale, bias, EPS, st, pd, "")
        mean, var = fwd_p[1], fwd_p[2]
        bwd_k = cbk.conv_bn_bwd(x, w, dy, scale, bias, mean, var, EPS, st,
                                pd, "")
        bwd_p = cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, mean, var, EPS,
                                      st, pd, "")
        torch.cuda.synchronize()
        aff_e, fwd_e, bwd_e = exact(x, w, scale, bias, dy, mean, var,
                                    stride, pad)
        names = ("conv_affine y", "y", "mean", "var", "dx", "dw", "dscale",
                 "dbias")
        for out, gk, gp, e in zip(names, aff_k + fwd_k + bwd_k,
                                  aff_p + fwd_p + bwd_p,
                                  aff_e + fwd_e + bwd_e):
            ek, rk = reading(gk, e)
            ep, rp = reading(gp, e)
            print(f"{name} | {out} | {ek:.3e} {rk:.3f} | {ep:.3e} "
                  f"{rp:.3f} | {e.abs().max().item():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
