"""The port's training conv+BN kernels against the reference's.

``conv_bn_train`` and ``conv_bn_bwd`` on CPU tensors run their plain
versions; each is held against the reference's Pallas kernel run in
interpret mode on the same numpy inputs, over 1x1 s1, 3x3 s1 p1 and 1x1 s2,
with a relu and without. A fused training program under
``kernel_tier=torch`` must agree bitwise with the unfused one, as the
reference pins within its own tiers. The kernels themselves are checked
against their plain versions where a card is present.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import conv_bn as jax_cbk
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import conv_bn as cbk
from paddle_tpu_torch.testing.models import resnet

REPO = pathlib.Path(__file__).resolve().parents[1]

# float32: the reference pins its Pallas kernels against their jnp twin at
# this tolerance (tests/test_fused_conv_bn.py); here the two packages also
# sum the taps in another order
F32_TOL = dict(rtol=2e-4, atol=1e-5)
# bfloat16 on the card: z and y are rounded to bfloat16 (one step is 2^-8
# of a value) and a different summation order can move each rounding by a
# step; dz is rounded too before the two gradient GEMMs
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# (kernel, stride, padding): the three geometries ResNet-50 fuses
GEOMS = [(1, 1, 0), (3, 1, 1), (1, 2, 0)]
EPS = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port():
    from paddle_tpu_torch.fluid import framework
    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    framework.reset_unique_name()
    tfluid.set_flags({"kernel_tier": "auto"})
    yield
    tfluid.set_flags({"kernel_tier": "auto"})


def _operands(k, stride, cin=8, cout=12, h=8, w=8, n=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, h, w, cin)).astype("float32")
    wt = (rng.normal(0, 1, (cout, cin, k, k))
          * (2.0 / (cin * k * k)) ** 0.5).astype("float32")
    scale = rng.uniform(0.5, 1.5, cout).astype("float32")
    bias = rng.normal(0, 0.1, cout).astype("float32")
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    dy = rng.normal(0, 1, (n, ho, wo, cout)).astype("float32")
    return x, wt, scale, bias, dy


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_conv_bn_train_matches_pallas(k, stride, pad, act):
    x, w, scale, bias, _ = _operands(k, stride)
    st, pd = (stride, stride), (pad, pad)
    want = jax_cbk.conv_bn_train_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), EPS, st, pd, act)
    got = cbk.conv_bn_train(_t(x), _t(w), _t(scale), _t(bias), EPS, st, pd,
                            act)
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == wv.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **F32_TOL)


@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_conv_bn_bwd_matches_pallas(k, stride, pad, act):
    x, w, scale, bias, dy = _operands(k, stride, seed=1)
    st, pd = (stride, stride), (pad, pad)
    _, mean, var = jax_cbk.conv_bn_train_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(bias), EPS, st, pd, act)
    want = jax_cbk.conv_bn_bwd_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy), jnp.asarray(scale),
        jnp.asarray(bias), mean, var, EPS, st, pd, act)
    got = cbk.conv_bn_bwd(_t(x), _t(w), _t(dy), _t(scale), _t(bias),
                          _t(mean), _t(var), EPS, st, pd, act)
    for name, g, wv in zip(("dx", "dw", "dscale", "dbias"), got, want):
        assert tuple(g.shape) == wv.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **F32_TOL,
                                   err_msg=name)


def test_backward_admits_the_forward_chains_on_resnet50():
    """The training kernels take the same 49 of ResNet-50's 53 chains in
    both directions, at the batch the training phase runs; the reference's
    forward admits the same ones (its backward budget is VMEM's)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        resnet(tfluid.layers.data("img", shape=[224, 224, 3]), 1000)
    assert tfluid.fuse_conv_bn(main) == 53
    block = main.global_block()
    port, ref = [], []
    for op in block.ops:
        if op.type != "fused_conv2d_bn":
            continue
        args = ((32,) + block.var(op.input("Input")[0]).shape[1:],
                block.var(op.input("Filter")[0]).shape,
                tuple(op.attr("strides")), tuple(op.attr("paddings")),
                tuple(op.attr("dilations")), op.attr("groups"), "NHWC")
        port.append(cbk.supported(*args, "float32"))
        ref.append(jax_cbk.supported(*args, jnp.float32))
    assert port == ref
    assert sum(port) == 49


def _train_program(fuse, steps=3, tier="torch"):
    """A conv+bn+relu, conv+bn chain with a softmax loss, trained with
    Momentum on one feed; returns the per-step losses and the final
    parameters."""
    tfluid.set_flags({"kernel_tier": tier})
    tfluid.reset_unique_name()
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 7
    L = tfluid.layers
    with tfluid.program_guard(main, startup):
        img = L.data("img", shape=[8, 8, 3])
        label = L.data("label", shape=[1], dtype="int64")
        h = L.batch_norm(L.conv2d(img, 8, 3, padding=1, bias_attr=False,
                                  data_format="NHWC"),
                         act="relu", data_layout="NHWC")
        h = L.batch_norm(L.conv2d(h, 8, 1, stride=2, bias_attr=False,
                                  data_format="NHWC"),
                         data_layout="NHWC")
        h = L.pool2d(h, pool_type="avg", global_pooling=True,
                     data_format="NHWC")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), label))
        if fuse:
            assert tfluid.fuse_conv_bn(main) == 2
        tfluid.optimizer.Momentum(0.1, 0.9).minimize(loss, startup)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"img": rng.normal(0, 1, (4, 8, 8, 3)).astype("float32"),
            "label": rng.randint(0, 4, (4, 1)).astype("int64")}
    losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
              for _ in range(steps)]
    params = {p.name: scope.find_var(p.name).numpy()
              for p in main.global_block().all_parameters()}
    return losses, params


def test_fused_program_bitwise_under_torch_tier():
    """The port's re-pin of the reference's
    test_fused_program_bitwise_under_jnp_tier: the fused op's plain route
    calls the unfused ops' helpers, so losses and every parameter (weights,
    BN scale/bias and running statistics) agree bitwise."""
    base_l, base_p = _train_program(False)
    fused_l, fused_p = _train_program(True)
    assert [float(v) for v in fused_l] == [float(v) for v in base_l]
    assert fused_l[-1] < fused_l[0], "training must reduce the loss"
    assert sorted(fused_p) == sorted(base_p)
    for name in base_p:
        np.testing.assert_array_equal(fused_p[name], base_p[name],
                                      err_msg=name)


def test_kernel_tier_routes_supported_chains_to_the_wrappers():
    """Under kernel_tier=cuda the 3x3 s1 and 1x1 s2 chains take the kernel
    wrappers (their plain versions on the CPU) in both directions, with no
    fallback, and track the plain op chain."""
    ttier.reset_fallback_counts()
    base_l, base_p = _train_program(True, tier="torch")
    kern_l, kern_p = _train_program(True, tier="cuda")
    assert ttier.fallback_counts() == {}
    np.testing.assert_allclose(np.array(kern_l), np.array(base_l), **F32_TOL)
    for name in base_p:
        np.testing.assert_allclose(kern_p[name], base_p[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_training_wrappers_raise_instead_of_falling_back():
    """Tensors off the CPU take the kernel route: without a card and nvcc
    the calls raise, and an unsupported shape raises before any build."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernels would build and run")
    x = torch.empty((2, 8, 8, 4), device="meta")
    w = torch.empty((6, 4, 1, 1), device="meta")
    dy = torch.empty((2, 8, 8, 6), device="meta")
    v = torch.empty((6,), device="meta")
    with pytest.raises(RuntimeError):
        cbk.conv_bn_train(x, w, v, v, EPS, (1, 1), (0, 0), "relu")
    with pytest.raises(RuntimeError):
        cbk.conv_bn_bwd(x, w, dy, v, v, v, v, EPS, (1, 1), (0, 0), "relu")
    w5 = torch.empty((6, 4, 5, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported shape"):
        cbk.conv_bn_train(x, w5, v, v, EPS, (1, 1), (2, 2), "")
    assert cbk.launches["conv_bn_train"] == 0
    assert cbk.launches["conv_bn_bwd"] == 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_conv_bn_train.py on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_training_kernels_match_plain_on_card(k, stride, pad, dtype):
    dev = _card()
    x, w, scale, bias, dy = (_t(a).to(dev) for a in _operands(
        k, stride, cin=40, cout=72, h=12, w=12, n=3, seed=2))
    tdt = getattr(torch, dtype)
    x, dy = x.to(tdt), dy.to(tdt)
    st, pd = (stride, stride), (pad, pad)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = cbk.conv_bn_train(x, w, scale, bias, EPS, st, pd, "relu")
    want = cbk.conv_bn_train_torch(x, w, scale, bias, EPS, st, pd, "relu")
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   wv.float().cpu().numpy(), **tol)
    mean, var = want[1], want[2]
    got = cbk.conv_bn_bwd(x, w, dy, scale, bias, mean, var, EPS, st, pd, "")
    want = list(cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, mean, var, EPS,
                                      st, pd, ""))
    if dtype == "float32":
        # dw sums over every pixel (432 here), so a float32 order of that
        # sum, the plain version's included, carries an error of ~1e-5 at
        # its elements near 0: each is held to the exact sum instead
        want[1] = _bwd_float64(x, w, dy, scale, mean, var, stride, pad)[1]
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   wv.float().cpu().numpy(), **tol)


def _bwd_float64(x, w, dy, scale, mean, var, stride, pad):
    """(dx, dw) of conv_bn_bwd without a relu, in float64 from the float32
    operands (dz exact, not rounded to float32)."""
    x, w, dy = x.double().cpu(), w.double().cpu(), dy.double().cpu()
    xn = x.permute(0, 3, 1, 2).requires_grad_(True)
    wn = w.clone().requires_grad_(True)
    with torch.enable_grad():
        zn = torch.nn.functional.conv2d(xn, wn, stride=stride, padding=pad)
    z = zn.detach().permute(0, 2, 3, 1)
    m = z.shape[0] * z.shape[1] * z.shape[2]
    inv = torch.rsqrt(var.double().cpu() + EPS)
    xh = (z.reshape(m, -1) - mean.double().cpu()) * inv
    d = dy.reshape(m, -1)
    dz = (scale.double().cpu() * inv / m) * (m * d - d.sum(0)
                                             - xh * (d * xh).sum(0))
    gx, gw = torch.autograd.grad(zn, (xn, wn),
                                 dz.reshape(z.shape).permute(0, 3, 1, 2))
    return gx.permute(0, 2, 3, 1), gw


# The kernels' float32 route (csrc/conv_mma.cuh): 3xTF32 on the tensor
# cores. Each operand splits into hi = tf32(a) and lo = tf32(a - hi) (round
# to 10 mantissa bits, ties away from zero: cvt.rna; a NaN or an infinity
# reaches lo as a NaN); an 8-deep slice runs three mma.sync into a fresh accumulator,
# lo·hi, then hi·lo, then hi·hi (tf32 products are exact), and the slice's
# sum is added to a float32 running sum with one rounding. The model below
# takes each mma's sum of 8 products and its accumulator exactly, then
# truncates it to float32 (the tensor core's adds truncate; how many bits
# it keeps inside one mma is not modelled), so it bounds the scheme, not
# the card's exact bits. chip_smoke.py phase 2 measures the kernels
# themselves against their plain versions (‖Δ‖∞/‖ref‖∞ ≤ REL_LIMIT, with
# the margin printed).
REL_LIMIT = 1e-4


def _int32(bits):
    """int64 bit patterns, taken mod 2^32, as float32."""
    bits = bits & 0xFFFFFFFF
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits) \
        .to(torch.int32).view(torch.float32)


def _tf32_rna(a):
    """The kernel's hi: (bits + 0x1000) & ~0x1fff, right for finite a."""
    return _int32((a.view(torch.int32).to(torch.int64) + 0x1000) & ~0x1FFF)


CARD_NAN = 0x7FFFFFFF  # the NaN a float32 operation on the card returns


def _to_f32_toward_zero(v):
    """float64 ``v`` to float32, rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _split_tf32(a):
    """The kernel's split: lo rounds a - hi (the card's NaN where a is a
    NaN or an infinity) and keeps the unrounded bits where the add would
    wrap past 0x7fffffff (a signed max)."""
    hi = _tf32_rna(a)
    d = (a - hi).view(torch.int32).to(torch.int64)
    d = torch.where(torch.isnan(a - hi), torch.full_like(d, CARD_NAN), d)
    up = (d + 0x1000) & 0xFFFFFFFF
    up = torch.where(up >= 2 ** 31, up - 2 ** 32, up)
    return hi, _int32(torch.maximum(up, d) & ~0x1FFF)


def _mma_dot(a, b, passes):
    """a [R, K] · b [K] as the kernel sums it: 3 passes (3xTF32) or 1
    (single-pass TF32, hi·hi only), each mma truncating its sum."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    acc = torch.zeros(a.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        sl = slice(k0, k0 + 8)
        pairs = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
        c = torch.zeros(a.shape[0], dtype=torch.float32)
        for p, q in pairs:
            c = _to_f32_toward_zero(
                c.double() + (p[:, sl].double() * q[sl].double()).sum(1))
        acc = acc + c
    return acc


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10   # a TF32 value: unchanged
    half = 2.0 ** -11        # half a TF32 step above 1: rounds away
    a = torch.tensor([1.0, one, 1.0 + half, -(1.0 + half),
                      1.0 + half - 2.0 ** -23], dtype=torch.float32)
    want = torch.tensor([1.0, one, one, -one, 1.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(a), want)
    hi, lo = _split_tf32(torch.tensor([1.0 / 3.0]))
    assert abs((hi.double() + lo.double()).item() - 1.0 / 3.0) \
        <= 2.0 ** -22 / 3.0
    # hi's add carries the card's NaN into its sign (-0.0), so lo carries
    # every NaN and infinity as a NaN, and finite lo's are rna's
    special = torch.tensor([CARD_NAN, -1, 0x7FC00000, 0x7F800001,
                            0x7F800000, -0x800000], dtype=torch.int32) \
        .view(torch.float32)
    assert _tf32_rna(special[:1]).view(torch.int32).item() == -2 ** 31
    assert torch.isnan(_split_tf32(special)[1]).all()
    v = torch.from_numpy(np.random.RandomState(1).normal(0, 1, 4096)
                         .astype("float32"))
    hi, lo = _split_tf32(v)
    assert torch.equal(lo, _tf32_rna(v - hi))


@pytest.mark.parametrize("k", [64, 576, 1152, 2304, 4608, 100352])
def test_3xtf32_model_holds_the_float32_limit(k):
    """At ResNet-50's reduction depths (Cin·kh·kw from 64 to 4608, and a dw
    GEMM's N·Ho·Wo = 100 352 pixels at 56x56, batch 32) the 3xTF32 sum is
    within REL_LIMIT of the float64 dot product with a wide margin, where
    single-pass TF32 is not. A bound on the split and its truncating
    accumulation as modelled; phase 2 of chip_smoke.py reads the kernels'
    own margin."""
    rng = np.random.RandomState(k)
    rows = 16 if k > 10000 else 64
    a = torch.from_numpy(rng.normal(0, 1, (rows, k)).astype("float32"))
    b = torch.from_numpy((rng.normal(0, 1, k) * (2.0 / k) ** 0.5)
                         .astype("float32"))
    ref = a.double() @ b.double()
    rel = ((_mma_dot(a, b, 3).double() - ref).abs().max()
           / ref.abs().max()).item()
    assert rel <= REL_LIMIT / 20, rel
    if k <= 4608:
        one = ((_mma_dot(a, b, 1).double() - ref).abs().max()
               / ref.abs().max()).item()
        assert one > REL_LIMIT, one


def _rel(got, want):
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_backward_relu_mask_is_the_forwards_on_card(k, stride, pad, dtype):
    """z of the backward's recompute is bitwise the forward's: with dy = 1,
    dbias counts the forward's y > 0 per channel exactly."""
    dev = _card()
    x, w, scale, bias, _ = (_t(a).to(dev) for a in _operands(
        k, stride, cin=64, cout=72, h=13, w=13, n=3, seed=3))
    x = x.to(getattr(torch, dtype))
    st, pd = (stride, stride), (pad, pad)
    y, mean, var = cbk.conv_bn_train(x, w, scale, bias, EPS, st, pd, "relu")
    dy = torch.ones_like(y)
    dbias = cbk.conv_bn_bwd(x, w, dy, scale, bias, mean, var, EPS, st, pd,
                            "relu")[3]
    torch.cuda.synchronize()
    want = (y.float() > 0).sum((0, 1, 2)).float()
    assert 0 < want.sum().item() < y.numel()
    assert torch.equal(dbias, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_training_kernels_bitwise_across_calls_on_card(k, stride, pad,
                                                       dtype):
    dev = _card()
    x, w, scale, bias, dy = (_t(a).to(dev) for a in _operands(
        k, stride, cin=64, cout=136, h=15, w=15, n=3, seed=4))
    tdt = getattr(torch, dtype)
    x, dy = x.to(tdt), dy.to(tdt)
    st, pd = (stride, stride), (pad, pad)
    args = (EPS, st, pd, "relu")
    f1 = cbk.conv_bn_train(x, w, scale, bias, *args)
    f2 = cbk.conv_bn_train(x, w, scale, bias, *args)
    b1 = cbk.conv_bn_bwd(x, w, dy, scale, bias, f1[1], f1[2], *args)
    b2 = cbk.conv_bn_bwd(x, w, dy, scale, bias, f1[1], f1[2], *args)
    torch.cuda.synchronize()
    for g1, g2 in zip(f1 + b1, f2 + b2):
        assert torch.equal(g1, g2)


# (dtype, Cin, Cout, N, H=W): M tails of every tile, Cout past one tile,
# channel counts off the 16-byte copies (float32 Cin 6; bfloat16 Cin 36 and
# 13, odd Cout), and the 128 x 128 and 128 x 64 tiles (pick_tile)
TAILS = [("float32", 36, 72, 3, 13), ("bfloat16", 36, 72, 3, 13),
         ("float32", 6, 13, 2, 9), ("bfloat16", 13, 10, 2, 9),
         ("float32", 64, 256, 4, 48), ("float32", 64, 64, 8, 48)]
CARD_REL = {"float32": REL_LIMIT, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cin,cout,n,hw", TAILS)
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_training_kernel_tails_match_plain_on_card(k, stride, pad, dtype,
                                                   cin, cout, n, hw):
    dev = _card()
    x, w, scale, bias, dy = (_t(a).to(dev) for a in _operands(
        k, stride, cin=cin, cout=cout, h=hw, w=hw, n=n, seed=5))
    tdt = getattr(torch, dtype)
    x, dy = x.to(tdt), dy.to(tdt)
    st, pd = (stride, stride), (pad, pad)
    got = cbk.conv_bn_train(x, w, scale, bias, EPS, st, pd, "relu")
    want = cbk.conv_bn_train_torch(x, w, scale, bias, EPS, st, pd, "relu")
    torch.cuda.synchronize()
    for name, g, wv in zip(("y", "mean", "var"), got, want):
        assert g.shape == wv.shape and g.dtype == wv.dtype, name
        assert _rel(g, wv) <= CARD_REL[dtype], (name, _rel(g, wv))
    got = cbk.conv_bn_bwd(x, w, dy, scale, bias, want[1], want[2], EPS, st,
                          pd, "")
    want = cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, want[1], want[2],
                                 EPS, st, pd, "")
    torch.cuda.synchronize()
    for name, g, wv in zip(("dx", "dw", "dscale", "dbias"), got, want):
        assert g.shape == wv.shape and g.dtype == wv.dtype, name
        assert _rel(g, wv) <= CARD_REL[dtype], (name, _rel(g, wv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_kernels_take_unaligned_views_on_card(dtype):
    """x and dy that start 4 bytes past a 16-byte boundary (contiguous
    views) give the aligned operands' results: the kernels copy 16 bytes
    at a time."""
    dev = _card()
    x, w, scale, bias, dy = (_t(a).to(dev) for a in _operands(
        3, 1, cin=64, cout=72, h=13, w=13, n=3, seed=6))
    tdt = getattr(torch, dtype)
    x, dy = x.to(tdt), dy.to(tdt)

    def shifted(t):
        flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)
        view = flat[4 // t.element_size():][:t.numel()].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        return view

    args = (EPS, (1, 1), (1, 1), "relu")
    want = cbk.conv_bn_train(x, w, scale, bias, *args)
    got = cbk.conv_bn_train(shifted(x), w, scale, bias, *args)
    want_b = cbk.conv_bn_bwd(x, w, dy, scale, bias, want[1], want[2], *args)
    got_b = cbk.conv_bn_bwd(shifted(x), w, shifted(dy), scale, bias,
                            want[1], want[2], *args)
    torch.cuda.synchronize()
    for g, wv in zip(got + got_b, want + want_b):
        assert torch.equal(g, wv)


def _planted(t, where, bits):
    """A copy of ``t`` with the float32 bit patterns ``bits`` at the
    indices ``where`` (set through an int32 view on the CPU, so that no
    conversion on the card replaces a NaN's payload)."""
    c = t.cpu().clone()
    for idx, b in zip(where, bits):
        c.view(torch.int32)[idx] = b
    return c.to(t.device)


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_training_kernels_propagate_nan_and_inf_on_card(k, stride, pad):
    """NaNs (the card's 0x7fffffff and its negative, 0xffffffff) or
    infinities in x or dy reach y, dx, dw, dscale and dbias where they
    reach the plain version's: every output is non-finite exactly where
    the plain version's is. (An infinite product may come out NaN: 3xTF32
    splits an infinity into Inf + NaN.)"""
    dev = _card()
    x, w, scale, bias, dy = (_t(a).to(dev) for a in _operands(
        k, stride, cin=40, cout=72, h=12, w=12, n=3, seed=7))
    st, pd = (stride, stride), (pad, pad)
    _, mean, var = cbk.conv_bn_train_torch(x, w, scale, bias, EPS, st, pd,
                                           "")

    def same_nonfinite(got, want, names):
        torch.cuda.synchronize()
        for name, g, wv in zip(names, got, want):
            assert torch.equal(torch.isfinite(g), torch.isfinite(wv)), name

    for bits in ((0x7FFFFFFF, -1), (0x7F800000, -0x800000)):
        xb = _planted(x, ((0, 0, 0, 5), (1, 2, 2, 7)), bits)
        for act in ("", "relu"):
            args = (EPS, st, pd, act)
            got = cbk.conv_bn_train(xb, w, scale, bias, *args)
            want = cbk.conv_bn_train_torch(xb, w, scale, bias, *args)
            same_nonfinite(got, want, ("y", "mean", "var"))
            assert not torch.isfinite(got[0]).any()
            got = cbk.conv_bn_bwd(xb, w, dy, scale, bias, mean, var, *args)
            want = cbk.conv_bn_bwd_torch(xb, w, dy, scale, bias, mean, var,
                                         *args)
            same_nonfinite(got, want, ("dx", "dw", "dscale", "dbias"))
            assert not torch.isfinite(got[1]).any()
        dyb = _planted(dy, ((0, 0, 0, 3), (1, 1, 1, 70)), bits)
        got = cbk.conv_bn_bwd(x, w, dyb, scale, bias, mean, var, EPS, st, pd,
                              "")
        want = cbk.conv_bn_bwd_torch(x, w, dyb, scale, bias, mean, var, EPS,
                                     st, pd, "")
        same_nonfinite(got, want, ("dx", "dw", "dscale", "dbias"))
        # dz is non-finite in channels 3 and 70 alone, and so is dw
        bad = ~torch.isfinite(got[1]).reshape(72, -1).all(1)
        assert bad.nonzero().flatten().tolist() == [3, 70]


def test_loop_stats_reads_the_main_loop_from_sass():
    """loop_stats.py (beside chip_smoke.py) counts the opcodes between a
    backward branch and its target, for the loop that holds the HMMAs, and
    names the conv kernel's tile from its mangled name."""
    spec = importlib.util.spec_from_file_location(
        "loop_stats", REPO / "loop_stats.py")
    loop_stats = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loop_stats)
    name = ("_ZN49_GLOBAL__N__8_16_conv_bn_train_cu_3b17conv_stats_kernelIfN7"
            "convmma4TileIfLi128ELi64ELb1ELb1EEEEEvPKT_")
    sass = f"""
        Function : {name}
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   LDS R4, [R2] ;
        /*0030*/                   HMMA.1688.F32.TF32 R8, R4, R6, RZ ;
        /*0040*/               @P0 FADD R9, R9, R8 ;
        /*0050*/              @!P1 BRA 0x10 ;
        /*0060*/                   EXIT ;
"""
    loops = loop_stats.main_loops(sass)
    assert loops == {name: {"BAR.SYNC.DEFER_BLOCKING": 1, "LDS": 1,
                            "HMMA.1688.F32.TF32": 1, "FADD": 1, "BRA": 1}}
    tile = loop_stats.KERNEL.search(name)
    assert (tile[1], tile[2], tile[3], tile[4]) == ("conv_stats_kernel",
                                                     "128", "64", "1")
    serving = ("_ZN49_GLOBAL__N__8_16_conv_affine_cu_3b18conv_affine_kernel"
               "IfN7convmma4TileIfLi64ELi128ELb1ELb0EEEEEvPKT_")
    tile = loop_stats.KERNEL.search(serving)
    assert (tile[1], tile[2], tile[3], tile[4]) == ("conv_affine_kernel",
                                                     "64", "128", "0")


@pytest.mark.parametrize("dtype,item", [(torch.float32, 4),
                                        (torch.bfloat16, 2)])
def test_scratch_parts_start_on_16_bytes_and_do_not_overlap(dtype, item):
    """The wrappers carve their scratch from one buffer: every part starts
    on 16 bytes (the kernels' vectorised copies) and the parts lie in
    turn inside it."""
    sizes = (3, 72 * 36, 1, 4096, 13)
    ptrs, buf = cbk._scratch(dtype, torch.device("cpu"), *sizes)
    base, end = buf.data_ptr(), buf.data_ptr() + buf.numel() * item
    assert base % 16 == 0 and buf.dtype == dtype
    for p, n, q in zip(ptrs, sizes, ptrs[1:] + [end]):
        assert (p - base) % 16 == 0 and p + n * item <= q <= end
    single, _ = cbk._scratch(dtype, torch.device("cpu"), 5)
    assert isinstance(single, int)
