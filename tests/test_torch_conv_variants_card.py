"""The conv_bn variants that the port's tuner chooses among (``-m cuda``;
JAX-free, so that it runs where there is none): the 128-row tile
(``tile=DB_TILE``, the tuner's ``pallas_db``) bitwise the default tile on
the card, statistics and gradients included; the bf16 variant within a
few bf16 steps of its twin and the AMP phase's bfloat16 limit of float32;
a tuned table routing an engine to the 128-row tile, and one naming the
plain chain leaving the kernel in place; a warm executable launching
conv_affine. On the GPU
machine: ``python -m pytest --noconftest -m cuda
tests/test_torch_conv_variants_card.py``."""

import math

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.ops import autotune as at
from paddle_tpu_torch.ops.cuda import conv_bn as cbk
from paddle_tpu_torch.serving import InferenceEngine
from paddle_tpu_torch.testing.models import resnet

# ResNet-50 shapes (x NHWC, w OIHW, stride, padding) where pick_tile takes
# 64 rows: at batch 1 and 8 every layer, at batch 32 the 7x7 layers
SHAPES = [
    ((1, 56, 56, 64), (64, 64, 3, 3), 1, 1),
    ((8, 28, 28, 512), (128, 512, 1, 1), 1, 0),
    ((8, 14, 14, 1024), (2048, 1024, 1, 1), 2, 0),
    ((32, 7, 7, 512), (512, 512, 3, 3), 1, 1),
    ((32, 7, 7, 2048), (512, 2048, 1, 1), 1, 0),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_conv_variants_card.py on the "
                    "GPU machine)")


def _operands(x_shape, w_shape, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    cout, cin, kh, kw = w_shape
    x = torch.randn(x_shape, generator=g, device="cuda")
    w = torch.randn(w_shape, generator=g, device="cuda") \
        * (2.0 / (cin * kh * kw)) ** 0.5
    a = torch.rand(cout, generator=g, device="cuda") + 0.5
    b = torch.randn(cout, generator=g, device="cuda") * 0.1
    return x, w, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: str(s[0]))
def test_db_tile_is_bitwise_the_default(shape):
    _need_card()
    x_shape, w_shape, s, p = shape
    strides, paddings = (s, s), (p, p)
    assert cbk.db_supported(x_shape, w_shape, strides, paddings, "float32")
    x, w, a, b = _operands(x_shape, w_shape)
    for act in ("", "relu"):
        y0 = cbk.conv_affine(x, w, a, b, strides, paddings, act)
        y1 = cbk.conv_affine(x, w, a, b, strides, paddings, act,
                             cbk.DB_TILE)
        assert torch.equal(y0, y1)
        t0 = cbk.conv_bn_train(x, w, a, b, 1e-5, strides, paddings, act)
        t1 = cbk.conv_bn_train(x, w, a, b, 1e-5, strides, paddings, act,
                               cbk.DB_TILE)
        assert all(torch.equal(u, v) for u, v in zip(t0, t1))
        dy = torch.randn_like(t0[0])
        g0 = cbk.conv_bn_bwd(x, w, dy, a, b, t0[1], t0[2], 1e-5, strides,
                             paddings, act)
        g1 = cbk.conv_bn_bwd(x, w, dy, a, b, t1[1], t1[2], 1e-5, strides,
                             paddings, act)
        assert all(torch.equal(u, v) for u, v in zip(g0, g1))


@pytest.mark.cuda
def test_db_tile_is_refused_where_it_is_the_default():
    _need_card()
    x, w, a, b = _operands((32, 56, 56, 64), (64, 64, 3, 3))
    assert not cbk.db_supported(tuple(x.shape), tuple(w.shape), (1, 1),
                                (1, 1), "float32")
    # the kernel library decides, and its C entry refuses the tile
    with pytest.raises(RuntimeError, match="conv_affine"):
        cbk.conv_affine(x, w, a, b, (1, 1), (1, 1), "", cbk.DB_TILE)


def _rel(y, ref):
    """Largest elementwise difference over the largest |ref|."""
    y, ref = y.float(), ref.float()
    return ((y - ref).abs().max() / ref.abs().max()).item()


def _bf16_steps(y, ref):
    """(max|y − ref| in bf16 steps at the largest |ref|, the share of
    elements that differ)."""
    y, ref = y.float(), ref.float()
    step = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
    return ((y - ref).abs().max().item() / step,
            (y != ref).float().mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[3:4],
                         ids=lambda s: str(s[0]))
def test_bf16_variant_within_the_amp_tolerance(shape):
    """The bf16 variant against its plain twin on the same bf16 input
    within chip_smoke.py's BF16_TWIN_STEPS (2 bf16 steps of the largest
    element) and BF16_TWIN_SHARE (1e-2 of the elements differing), where
    float32's output rounded to bf16 is not; against float32's kernel
    within the AMP phase's bfloat16 limit (REL_LIMIT, 2e-2 of the largest
    element): a bf16 z rounds by up to 2^-5 at ~8, so elementwise near a
    relu's edge a few elements in 10^5 move by ~0.02."""
    _need_card()
    x_shape, w_shape, s, p = shape
    strides, paddings = (s, s), (p, p)
    x, w, a, b = _operands(x_shape, w_shape, seed=1)
    xb = x.to(torch.bfloat16)
    y = cbk.conv_affine(x, w, a, b, strides, paddings, "relu")
    yb = cbk.conv_affine(xb, w, a, b, strides, paddings, "relu")
    twin = cbk.conv_affine_torch(xb, w, a, b, strides, paddings, "relu")
    steps, share = _bf16_steps(yb, twin)
    assert steps <= 2 and share <= 1e-2
    steps, share = _bf16_steps(y.to(torch.bfloat16), twin)
    assert steps > 2 or share > 1e-2
    assert _rel(yb, y) <= 2e-2
    t = cbk.conv_bn_train(x, w, a, b, 1e-5, strides, paddings, "relu")
    tb = cbk.conv_bn_train(xb, w, a, b, 1e-5, strides, paddings, "relu")
    for u, v in zip(tb, t):
        assert _rel(u, v) <= 2e-2


def _convnet_bundle(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[32, 32, 4])
        out = fluid.layers.softmax(resnet(img, 10, counts=(1, 1, 1, 1),
                                          base=8))
    fluid.fuse_conv_bn(main)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "bundle")
    fluid.io.save_inference_model(d, ["img"], [out], exe, main, scope=scope)
    x = np.random.RandomState(0).normal(0, 1, (4, 32, 32, 4)) \
        .astype("float32")
    return d, {"img": x}


@pytest.mark.cuda
def test_tuned_table_routes_the_engine_to_the_db_tile(tmp_path):
    _need_card()
    d, feed = _convnet_bundle(tmp_path)
    cold = InferenceEngine(d, buckets=[4], exec_cache=False)
    cold.warmup()
    want = cold.infer(feed)[0]
    with at.capture() as keys:
        cold.infer(feed)
    table = at.TuneTable()
    for kernel, key, names in keys:
        if "pallas_db" in names:
            table.set(kernel, key, "pallas_db")
    n_db = sum(1 for _k, _key, names in keys if "pallas_db" in names)
    assert table.entries and n_db
    at.attach_table(table)
    try:
        cbk.reset_launches()
        got = cold.infer(feed)[0]
        assert cbk.launches["conv_affine_db"] == n_db
    finally:
        at.detach_table()
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_warm_executable_launches_conv_affine(tmp_path):
    _need_card()
    d, feed = _convnet_bundle(tmp_path)
    cold = InferenceEngine(d, buckets=[4], exec_cache=False)
    cold.warmup()
    want = cold.infer(feed)[0]
    cache = str(tmp_path / "cache")
    InferenceEngine(d, buckets=[4], exec_cache=cache).warmup()
    hit = InferenceEngine(d, buckets=[4], exec_cache=cache)
    assert hit.warmup() == 0
    cbk.reset_launches()
    got = hit.infer(feed)[0]
    assert cbk.launches["conv_affine"] == 13
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_a_plain_table_entry_never_displaces_the_kernel(tmp_path):
    _need_card()
    d, feed = _convnet_bundle(tmp_path)
    eng = InferenceEngine(d, buckets=[4], exec_cache=False)
    eng.warmup()
    with at.capture() as keys:
        want = eng.infer(feed)[0]
    table = at.TuneTable()
    for kernel, key, _names in keys:
        table.set(kernel, key, "jnp")
    n = sum(1 for kernel, _key, names in keys
            if kernel == "conv_bn" and "pallas" in names)
    at.attach_table(table)
    try:
        cbk.reset_launches()
        got = eng.infer(feed)[0]
        assert n and cbk.launches["conv_affine"] == n
    finally:
        at.detach_table()
    assert np.array_equal(got, want)
