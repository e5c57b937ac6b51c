"""The port's fused conv+affine kernel module against the reference's.

``paddle_tpu_torch.ops.cuda.conv_bn.conv_affine`` on CPU tensors runs its
plain version, ``conv_affine_torch``; it is held against the reference's
``conv_affine_pallas`` run in interpret mode on the same numpy inputs, over
1x1/3x3 taps, stride 1/2, relu/none, float32 and bfloat16, and on inputs
holding NaNs and infinities. ``supported()`` must admit exactly the shapes
the reference admits on ResNet-50. A call that needs the kernel raises when
it cannot have it, and the kernel itself is checked against the plain
version where a card is present: tails, bitwise repeats at the small
serving buckets' grids, unaligned views, NaN and infinities.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import conv_bn as jax_cbk
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops.cuda import conv_bn as cbk
from paddle_tpu_torch.testing.models import resnet

# float32: the repo's own fused-kernel tolerance (tests/test_fused_conv_bn.py)
F32_TOL = dict(rtol=2e-4, atol=1e-5)
# bfloat16: the conv sum is rounded to bfloat16 before the affine and the
# result is stored in bfloat16; one bfloat16 step is 2^-8 (~3.9e-3) of a
# value, and the two packages may sum the taps in another order, so a
# rounding can land one step apart at each of the two roundings
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

# (kernel, stride, padding) — every geometry the kernel takes
GEOMS = [(1, 1, 0), (3, 1, 1), (3, 1, 0), (1, 2, 0)]
# on the card, ‖kernel − plain‖∞/‖plain‖∞: chip_smoke.py's REL_LIMIT (the
# two sum the same products in another order; bfloat16 rounds the sum and
# the output to bfloat16, a step of which is 2^-8 of a value)
CARD_REL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _fresh_port():
    from paddle_tpu_torch.fluid import framework
    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    framework.reset_unique_name()
    tfluid.set_flags({"kernel_tier": "auto"})
    yield
    tfluid.set_flags({"kernel_tier": "auto"})


def _operands(k, cin=8, cout=12, h=7, w=6, n=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (n, h, w, cin)).astype("float32")
    wt = (rng.normal(0, 1, (cout, cin, k, k))
          * (2.0 / (cin * k * k)) ** 0.5).astype("float32")
    a = rng.uniform(0.5, 1.5, cout).astype("float32")
    b = rng.normal(0, 0.1, cout).astype("float32")
    return x, wt, a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_conv_affine_matches_pallas(k, stride, pad, act, dtype):
    x, w, a, b = _operands(k)
    strides, paddings = (stride, stride), (pad, pad)
    want = jax_cbk.conv_affine_pallas(
        jnp.asarray(x).astype(dtype), jnp.asarray(w), jnp.asarray(a),
        jnp.asarray(b), strides, paddings, act)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = cbk.conv_affine(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                          torch.from_numpy(a), torch.from_numpy(b), strides,
                          paddings, act)
    assert got.dtype == tdt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


# (index, value) planted in _operands' x [2, 7, 6, 8]: a NaN, each
# infinity alone, and +Inf and -Inf inside one 3x3 window (Inf - Inf);
# the second and third lie on even positions, which stride 2 reads
PLANTED = [((0, 0, 0, 5), np.nan), ((1, 2, 2, 7), np.inf),
           ((1, 4, 2, 1), -np.inf), ((0, 3, 3, 0), np.inf),
           ((0, 4, 4, 3), -np.inf)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["", "relu"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_conv_affine_nan_and_inf_match_pallas(k, stride, pad, act, dtype):
    """NaNs and infinities in x reach the plain version's output where they
    reach the reference's: NaN at the same positions (the relu keeps a NaN,
    as jnp.maximum does), the same infinities, and the finite rest within
    the usual tolerance."""
    x, w, a, b = _operands(k)
    for idx, v in PLANTED:
        x[idx] = v
    strides, paddings = (stride, stride), (pad, pad)
    want = jax_cbk.conv_affine_pallas(
        jnp.asarray(x).astype(dtype), jnp.asarray(w), jnp.asarray(a),
        jnp.asarray(b), strides, paddings, act)
    want = np.asarray(want.astype(jnp.float32))
    got = cbk.conv_affine(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w), torch.from_numpy(a),
                          torch.from_numpy(b), strides, paddings, act)
    got = got.float().numpy()
    assert np.isnan(want).any() and np.isposinf(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin],
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


def _resnet50_fused_shapes():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.layers.data("img", shape=[224, 224, 3])
        resnet(img, 1000)
    assert tfluid.fuse_conv_bn(main) == 53
    block = main.global_block()
    for op in block.ops:
        if op.type == "fused_conv2d_bn":
            x = (8,) + block.var(op.input("Input")[0]).shape[1:]
            w = block.var(op.input("Filter")[0]).shape
            yield (x, w, tuple(op.attr("strides")), tuple(op.attr("paddings")),
                   tuple(op.attr("dilations")), op.attr("groups"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_supported_parity_on_resnet50(dtype):
    """The port drops the reference's VMEM budget but keeps its structural
    conditions: on ResNet-50 both admit the same 49 of 53 convs."""
    port, ref = [], []
    for x, w, s, p, d, g in _resnet50_fused_shapes():
        port.append(cbk.supported(x, w, s, p, d, g, "NHWC", dtype))
        ref.append(jax_cbk.supported(x, w, s, p, d, g, "NHWC",
                                     getattr(jnp, dtype)))
    assert port == ref
    assert sum(port) == 49 and len(port) - sum(port) == 4


@pytest.mark.parametrize("case", [
    dict(k=5, stride=1, pad=2),               # no 5x5 kernel
    dict(k=3, stride=2, pad=1),               # 3x3/s2 is the plain route
    dict(k=1, stride=2, pad=1),               # strided 1x1 takes no padding
])
def test_supported_rejects_outside_shapes(case):
    x_shape, w_shape = (2, 8, 8, 4), (6, 4, case["k"], case["k"])
    s, p = (case["stride"],) * 2, (case["pad"],) * 2
    assert not cbk.supported(x_shape, w_shape, s, p, (1, 1), 1, "NHWC",
                             "float32")
    assert not jax_cbk.supported(x_shape, w_shape, s, p, (1, 1), 1, "NHWC",
                                 jnp.float32)


def test_supported_rejects_layout_groups_dilation_dtype():
    x, w = (2, 8, 8, 4), (6, 4, 3, 3)
    ok = dict(strides=(1, 1), paddings=(1, 1), dilations=(1, 1), groups=1,
              data_format="NHWC", x_dtype="float32")
    assert cbk.supported(x, w, **ok)
    for bad in (dict(data_format="NCHW"), dict(groups=2),
                dict(dilations=(2, 2)), dict(x_dtype="float16")):
        assert not cbk.supported(x, w, **{**ok, **bad}), bad


def test_kernel_route_raises_instead_of_falling_back():
    """A tensor that is not on the CPU takes the kernel route: without a
    CUDA card and nvcc the call raises — it never quietly runs the plain
    version. An unsupported shape raises before any build."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would build and run")
    x, w, a, b = (torch.empty(s, device="meta") for s in
                  ((2, 8, 8, 4), (6, 4, 1, 1), (6,), (6,)))
    with pytest.raises(RuntimeError):
        cbk.conv_affine(x, w, a, b, (1, 1), (0, 0), "relu")
    w5 = torch.empty((6, 4, 5, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported shape"):
        cbk.conv_affine(x, w5, a, b, (1, 1), (2, 2), "relu")
    assert cbk.launches["conv_affine"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_kernel_matches_plain_on_card(k, stride, pad, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_conv_bn.py on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, a, b = (torch.from_numpy(t).cuda() for t in _operands(k, cin=40,
                                                                 cout=72))
    x = x.to(getattr(torch, dtype))
    before = cbk.launches["conv_affine"]
    got = cbk.conv_affine(x, w, a, b, (stride, stride), (pad, pad), "relu")
    torch.cuda.synchronize()
    assert cbk.launches["conv_affine"] == before + 1
    want = cbk.conv_affine_torch(x, w, a, b, (stride, stride), (pad, pad),
                                 "relu")
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_conv_bn.py on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got, want):
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30)


def _planted(t, where, bits):
    """A copy of float32 ``t`` with the bit patterns ``bits`` at the
    indices ``where`` (set through an int32 view on the CPU, so that no
    conversion on the card replaces a NaN's payload)."""
    c = t.cpu().clone()
    for idx, v in zip(where, bits):
        c.view(torch.int32)[idx] = v
    return c.to(t.device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_conv_affine_propagates_nan_and_inf_on_card(k, stride, pad, dtype):
    """NaNs (the card's 0x7fffffff and its negative, 0xffffffff) or
    infinities in x reach y where they reach the plain version's: NaN at
    the same positions (the relu keeps a NaN; fmaxf would drop it), the
    same infinities, the finite rest within CARD_REL. float32 runs 3xTF32,
    which splits an infinity into Inf + NaN, so this also holds the
    kernel's direct re-sum of the elements the tensor cores gave NaN."""
    dev = _card()
    x, w, a, b = (torch.from_numpy(t).to(dev) for t in _operands(
        k, cin=40, cout=72, h=12, w=12, n=3, seed=7))
    st, pd = (stride, stride), (pad, pad)
    tdt = getattr(torch, dtype)
    for bits in ((0x7FFFFFFF, -1), (0x7F800000, -0x800000)):
        xb = _planted(x, ((0, 0, 0, 5), (1, 2, 2, 7)), bits).to(tdt)
        for act in ("", "relu"):
            got = cbk.conv_affine(xb, w, a, b, st, pd, act)
            want = cbk.conv_affine_torch(xb, w, a, b, st, pd, act)
            torch.cuda.synchronize()
            bad = ~torch.isfinite(want)
            assert bad.any() and not bad.all()
            assert torch.equal(torch.isnan(got), torch.isnan(want)), \
                (bits, act)
            inf = torch.isinf(want)
            assert torch.equal(torch.isinf(got), inf), (bits, act)
            assert torch.equal(got[inf], want[inf]), (bits, act)
            fin = ~bad
            assert _rel(got[fin], want[fin]) <= CARD_REL[dtype], act


# (N, H=W, Cin, Cout, k, stride, pad): ResNet-50's layers at batch 1, whose
# grids fill few SMs (7x7 3x3 512: 4 blocks, each walking K = 4608; 14x14
# 3x3 256 and 1x1 1024 -> 256), and a 56x56 1x1 64 -> 64 (2 K steps)
SMALL_GRIDS = [(1, 7, 512, 512, 3, 1, 1), (1, 14, 256, 256, 3, 1, 1),
               (1, 14, 1024, 256, 1, 1, 0), (1, 56, 64, 64, 1, 1, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,hw,cin,cout,k,stride,pad", SMALL_GRIDS)
def test_conv_affine_bitwise_across_calls_on_card(n, hw, cin, cout, k,
                                                  stride, pad, dtype):
    """Two calls give the same bits (each block sums its K walk in one
    fixed order, no atomics), and agree with the plain version."""
    dev = _card()
    x, w, a, b = (torch.from_numpy(t).to(dev) for t in _operands(
        k, cin=cin, cout=cout, h=hw, w=hw, n=n, seed=4))
    x = x.to(getattr(torch, dtype))
    st, pd = (stride, stride), (pad, pad)
    y1 = cbk.conv_affine(x, w, a, b, st, pd, "relu")
    y2 = cbk.conv_affine(x, w, a, b, st, pd, "relu")
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    want = cbk.conv_affine_torch(x, w, a, b, st, pd, "relu")
    assert _rel(y1, want) <= CARD_REL[dtype]


# (dtype, Cin, Cout, N, H=W): M tails of every tile, Cout past one tile,
# channel counts off the 16-byte copies (float32 Cin 6; bfloat16 Cin 36 and
# 13, odd Cout), the 128 x 128 and 128 x 64 tiles (pick_tile), and two
# batch-1 7x7 calls on one block (Cout 13, and bfloat16 Cout 72)
TAILS = [("float32", 36, 72, 3, 13), ("bfloat16", 36, 72, 3, 13),
         ("float32", 6, 13, 2, 9), ("bfloat16", 13, 10, 2, 9),
         ("float32", 64, 256, 4, 48), ("float32", 64, 64, 8, 48),
         ("float32", 36, 13, 1, 7), ("bfloat16", 40, 72, 1, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cin,cout,n,hw", TAILS)
@pytest.mark.parametrize("k,stride,pad", GEOMS)
def test_conv_affine_tails_match_plain_on_card(k, stride, pad, dtype, cin,
                                               cout, n, hw):
    dev = _card()
    x, w, a, b = (torch.from_numpy(t).to(dev) for t in _operands(
        k, cin=cin, cout=cout, h=hw, w=hw, n=n, seed=5))
    x = x.to(getattr(torch, dtype))
    st, pd = (stride, stride), (pad, pad)
    for act in ("", "relu"):
        got = cbk.conv_affine(x, w, a, b, st, pd, act)
        want = cbk.conv_affine_torch(x, w, a, b, st, pd, act)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _rel(got, want) <= CARD_REL[dtype], (act, _rel(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_affine_takes_unaligned_views_on_card(dtype):
    """x that starts 4 bytes past a 16-byte boundary (a contiguous view)
    gives the aligned operand's result: the kernel copies 16 bytes at a
    time."""
    dev = _card()
    x, w, a, b = (torch.from_numpy(t).to(dev) for t in _operands(
        3, cin=64, cout=72, h=13, w=13, n=3, seed=6))
    x = x.to(getattr(torch, dtype))
    flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=dev)
    view = flat[4 // x.element_size():][:x.numel()].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    args = ((1, 1), (1, 1), "relu")
    want = cbk.conv_affine(x, w, a, b, *args)
    got = cbk.conv_affine(view, w, a, b, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
