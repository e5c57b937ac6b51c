"""The port's training conv+BN kernels against the reference's.

``conv_bn_train`` and ``conv_bn_bwd`` on CPU tensors run their plain
versions; each is held against the reference's Pallas kernel run in
interpret mode on the same numpy inputs, over 1x1 s1, 3x3 s1 p1 and 1x1 s2,
with a relu and without. A fused training program under
``kernel_tier=torch`` must agree bitwise with the unfused one, as the
reference pins within its own tiers. The kernels themselves are checked
against their plain versions where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import conv_bn as jax_cbk
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import conv_bn as cbk
from paddle_tpu_torch.testing.models import resnet

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
    want = cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, mean, var, EPS, st,
                                 pd, "")
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   wv.float().cpu().numpy(), **tol)
