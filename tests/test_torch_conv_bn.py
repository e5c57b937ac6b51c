"""The port's fused conv+affine kernel module against the reference's.

``paddle_tpu_torch.ops.cuda.conv_bn.conv_affine`` on CPU tensors runs its
plain version, ``conv_affine_torch``; it is held against the reference's
``conv_affine_pallas`` run in interpret mode on the same numpy inputs, over
1x1/3x3 taps, stride 1/2, relu/none, float32 and bfloat16. ``supported()``
must admit exactly the shapes the reference admits on ResNet-50. A call that
needs the kernel raises when it cannot have it, and the kernel itself is
checked against the plain version where a card is present.
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
