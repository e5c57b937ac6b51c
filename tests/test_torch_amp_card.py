"""AMP's kernel route on the card: the conv kernels on bf16 x, counted by
dtype, and the float32 master filter giving the same launch as its bf16
cast. Skips without a CUDA card (run: python -m pytest -m cuda
tests/test_torch_amp_card.py on the GPU machine). Imports no JAX: each
kernel is held against its own plain version and its bf16-filter launch.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops.cuda import conv_bn as cbk

EPS = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_amp_card.py on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _fresh():
    from paddle_tpu_torch.fluid import framework
    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    framework.reset_unique_name()
    tfluid.set_flags({"kernel_tier": "auto"})
    yield
    tfluid.set_flags({"kernel_tier": "auto"})


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (1, 2, 0)])
def test_float32_and_bf16_filters_launch_alike_on_card(k, stride, pad):
    """The fused op under AMP hands the wrappers the float32 master filter;
    each kernel lays it out in bf16 rounding to nearest even, so its
    outputs are bitwise those of the same launch with the filter cast to
    bf16 first."""
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cin, cout = 40, 72
    x = torch.randn((3, 12, 12, cin), generator=gen, device=dev).bfloat16()
    w = torch.randn((cout, cin, k, k), generator=gen, device=dev) \
        * (2.0 / (cin * k * k)) ** 0.5
    scale = torch.rand(cout, generator=gen, device=dev) + 0.5
    bias = torch.randn((cout,), generator=gen, device=dev) * 0.1
    st, pd = (stride, stride), (pad, pad)
    for wk in (w, w.bfloat16()):
        y, mean, var = cbk.conv_bn_train(x, wk, scale, bias, EPS, st, pd,
                                         "relu")
        dy = torch.randn(y.shape, generator=gen, device=dev).bfloat16() \
            if wk is w else dy
        outs = [y, mean, var,
                *cbk.conv_bn_bwd(x, wk, dy, scale, bias, mean, var, EPS, st,
                                 pd, "relu"),
                cbk.conv_affine(x, wk, scale, bias, st, pd, "relu")]
        if wk is w:
            first = outs
    torch.cuda.synchronize()
    for a, b in zip(first, outs):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_amp_program_counts_bf16_launches_on_card():
    """A fused conv+bn program under Executor(amp=True) on the card: each
    step launches both training kernels on bf16 x for its two supported
    chains, and the parameters stay float32."""
    _card()
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
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
        assert tfluid.fuse_conv_bn(main) == 2
        tfluid.optimizer.Momentum(0.1, 0.9, fused=True).minimize(
            loss, startup)
    scope = tfluid.Scope()
    exe = tfluid.Executor(amp=True)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(2)
    feed = {"img": rng.normal(0, 1, (8, 8, 8, 3)).astype("float32"),
            "label": rng.randint(0, 4, (8, 1)).astype("int64")}
    for _ in range(2):
        cbk.reset_launches()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]
        assert np.isfinite(out)
        assert cbk.launches_by_dtype["conv_bn_train"] == {"bfloat16": 2}
        assert cbk.launches_by_dtype["conv_bn_bwd"] == {"bfloat16": 2}
    for p in main.global_block().all_parameters():
        assert scope.find_var(p.name).dtype == torch.float32, p.name
