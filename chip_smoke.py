#!/usr/bin/env python3
"""Serve ResNet-50 through the PyTorch/CUDA port on one GPU and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each of which exits non-zero on a failed check:

1. build   — compile csrc/conv_affine.cu with nvcc; print the card's name
             and power limit, the torch and nvcc versions, and the TF32
             switches (both off: every float32 reference is full float32).
2. kernels — every distinct fused conv shape of ResNet-50 at batch 8, in
             float32 and bfloat16, with and without relu: the kernel against
             ``conv_affine_torch``. Then, at batch 32 in float32, the time of
             the kernel wrapper, of the plain version and of one cuDNN call
             computing the same function (a yardstick the port never calls),
             beside the least time the card could take.
3. serving — ResNet-50 (224x224x3, 1000 classes, softmax fetch) built with
             the port's front end, random weights from the seed, BN
             statistics overwritten so the folded affine is not trivial;
             fuse_conv_bn, save_inference_model, InferenceEngine, warmup;
             requests of batch 1, 3, 8, 32 and 40 (the last one chunks),
             each compared with the same bundle served under
             kernel_tier=torch. Each forward must launch conv_affine 49
             times and route 4 convs to the plain op chain.

The last two lines of output are a JSON line listing each kernel's numbers
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA
# cores, bfloat16 on the tensor cores, and device memory bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# max ‖kernel − plain‖∞ / ‖plain‖∞. float32: both sum the same float32
# products, in another order; with K ≤ 4608 terms that moves a sum by far
# less than 1e-4 of the largest output. bfloat16: the conv sum is rounded to
# bfloat16 before the affine and the output is stored in bfloat16, and one
# bfloat16 step is 2^-8 ≈ 3.9e-3 of a value; a different summation order can
# move a rounding by a step at each of the two roundings, so 2e-2 leaves
# room for a few steps and no more.
REL_LIMIT = {"float32": 1e-4, "bfloat16": 2e-2}

IMAGE, CLASSES = 224, 1000
REQUESTS = (1, 3, 8, 32, 40)
KERNEL_CONVS, PLAIN_CONVS = 49, 4


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, torch, target_ms=30.0):
    """Mean device time of ``fn`` in ms: CUDA events around enough calls to
    fill ~target_ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    reps = int(min(200, max(3, target_ms / max(s.elapsed_time(e), 1e-3))))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def build_resnet50(fluid, seed):
    from paddle_tpu_torch.testing.models import resnet
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[IMAGE, IMAGE, 3])
        prob = fluid.layers.softmax(resnet(img, CLASSES))
    return main, startup, prob


def fused_conv_shapes(fluid, main, batch):
    """{(x_shape, w_shape, strides, paddings, act): count per forward} over
    the fused conv+bn ops of a fused program, at ``batch``."""
    from paddle_tpu_torch.ops.conv_ops import conv_attrs
    block = main.global_block()
    shapes = {}
    for op in block.ops:
        if op.type != "fused_conv2d_bn":
            continue
        x = (batch,) + tuple(block.var(op.input("Input")[0]).shape[1:])
        w = tuple(block.var(op.input("Filter")[0]).shape)
        strides, paddings, dilations, groups = conv_attrs(op.attr)
        key = (x, w, strides, paddings, dilations, groups,
               op.attr("act", "") or "")
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def conv_work(x, w, strides, paddings, itemsize):
    """(operations, bytes) of one conv_affine call: the multiply-adds and
    the affine, and each input read once and the output written once."""
    n, h, wd, cin = x
    cout, _, kh, kw = w
    ho = (h + 2 * paddings[0] - kh) // strides[0] + 1
    wo = (wd + 2 * paddings[1] - kw) // strides[1] + 1
    m = n * ho * wo
    ops = 2 * m * cout * kh * kw * cin + 2 * m * cout
    nbytes = (n * h * wd * cin * itemsize + cout * cin * kh * kw * 4
              + 2 * cout * 4 + m * cout * itemsize)
    return ops, nbytes


def phase_kernels(torch, fluid, seed):
    """Kernel vs plain on every distinct ResNet-50 fused shape, then times.
    Returns the per-forward sums for the kernels line."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk

    main, _, _ = build_resnet50(fluid, seed)
    fluid.fuse_conv_bn(main)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def operands(x_shape, w_shape, dtype):
        cout, cin, kh, kw = w_shape
        x = torch.randn(x_shape, generator=gen, device=dev).to(dtype)
        w = torch.randn(w_shape, generator=gen, device=dev) \
            * (2.0 / (cin * kh * kw)) ** 0.5
        a = torch.rand(cout, generator=gen, device=dev) + 0.5
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        return x, w, a, b

    def rel_err(y, ref):
        y, ref = y.float(), ref.float()
        d = (y - ref).abs().max().item()
        return d / max(ref.abs().max().item(), 1e-30), d

    shapes8 = fused_conv_shapes(fluid, main, 8)
    kernel_keys = [k for k in shapes8 if cbk.supported(
        k[0], k[1], k[2], k[3], k[4], k[5], "NHWC", "float32")]
    n_kernel = sum(shapes8[k] for k in kernel_keys)
    n_plain = sum(shapes8.values()) - n_kernel
    if (n_kernel, n_plain) != (KERNEL_CONVS, PLAIN_CONVS):
        fail(f"ResNet-50 routes {n_kernel} convs to conv_affine and "
             f"{n_plain} to the plain chain, want {KERNEL_CONVS}/"
             f"{PLAIN_CONVS}")
    geoms = sorted({k[:4] for k in kernel_keys},
                   key=lambda g: (-g[0][1], g[1][1], g[1][0], g[2]))
    log(f"\n== phase 2: conv_affine vs conv_affine_torch, {len(geoms)} "
        f"distinct shapes, batch 8 ==")
    max_abs = 0.0
    errs = {}
    for x_shape, w_shape, strides, paddings in geoms:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for act in ("", "relu"):
                x, w, a, b = operands(x_shape, w_shape, dtype)
                y = cbk.conv_affine(x, w, a, b, strides, paddings, act)
                torch.cuda.synchronize()
                ref = cbk.conv_affine_torch(x, w, a, b, strides, paddings,
                                            act)
                if y.shape != ref.shape or y.dtype != ref.dtype:
                    fail(f"conv_affine {x_shape} {w_shape}: got "
                         f"{tuple(y.shape)}/{y.dtype}, want "
                         f"{tuple(ref.shape)}/{ref.dtype}")
                rel, d = rel_err(y, ref)
                if dtype == torch.float32:
                    max_abs = max(max_abs, d)
                key = (x_shape[1:], w_shape, strides, dname)
                errs[key] = max(errs.get(key, 0.0), rel)
                if not rel <= REL_LIMIT[dname]:
                    fail(f"conv_affine x{x_shape} w{w_shape} s{strides} "
                         f"{dname} act={act!r}: rel err {rel:.3e} > "
                         f"{REL_LIMIT[dname]:.0e}")

    log("\n== conv_affine times, batch 32, float32, per shape ==")
    log("  x[N,H,W,C] w[O,I,kh,kw] s act n/fwd | rel_err f32 bf16 | "
        "kernel_ms plain_ms library_ms bound_ms bound_by")
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
             "ops": 0, "bytes": 0}
    for key, count in sorted(fused_conv_shapes(fluid, main, 32).items(),
                             key=lambda kv: (-kv[0][0][1], kv[0][1][1],
                                             kv[0][1][0], kv[0][2])):
        x_shape, w_shape, strides, paddings, _, _, act = key
        if not cbk.supported(x_shape, w_shape, strides, paddings, (1, 1), 1,
                             "NHWC", "float32"):
            continue
        x, w, a, b = operands(x_shape, w_shape, torch.float32)
        k_ms = time_ms(lambda: cbk.conv_affine(x, w, a, b, strides,
                                               paddings, act), torch)
        p_ms = time_ms(lambda: cbk.conv_affine_torch(x, w, a, b, strides,
                                                     paddings, act), torch)
        xn = x.permute(0, 3, 1, 2)          # NCHW view, channels-last
        wf = w * a.view(-1, 1, 1, 1)

        def library():
            y = F.conv2d(xn, wf, b, stride=strides, padding=paddings)
            return torch.relu(y) if act == "relu" else y

        l_ms = time_ms(library, torch)
        ops, nbytes = conv_work(x_shape, w_shape, strides, paddings, 4)
        t_ops = ops / PEAK_FLOPS["float32"] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        e32 = errs[(x_shape[1:], w_shape, strides, "float32")]
        e16 = errs[(x_shape[1:], w_shape, strides, "bfloat16")]
        log(f"  {list(x_shape)} {list(w_shape)} {strides[0]} "
            f"{act or '-':4} {count} | {e32:.2e} {e16:.2e} | "
            f"{k_ms:.4f} {p_ms:.4f} {l_ms:.4f} {bound:.4f} {by}")
        total["ms"] += count * k_ms
        total["plain_ms"] += count * p_ms
        total["library_ms"] += count * l_ms
        total["bound_ms"] += count * bound
        total["ops"] += count * ops
        total["bytes"] += count * nbytes
    t_ops = total["ops"] / PEAK_FLOPS["float32"]
    t_bytes = total["bytes"] / PEAK_BYTES
    total["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    total["max_abs_err"] = max_abs
    log(f"  per forward at batch 32 (49 convs): kernel {total['ms']:.3f} ms, "
        f"plain {total['plain_ms']:.3f} ms, cuDNN {total['library_ms']:.3f} "
        f"ms, bound {total['bound_ms']:.3f} ms "
        f"({total['ops'] / total['ms'] / 1e9:.1f} TFLOP/s achieved)")
    return total


def overwrite_bn_stats(main, scope, torch, seed):
    """Seeded non-trivial BN scale/bias/mean/variance, so the folded affine
    a = scale·rsqrt(var+eps), b = bias − mean·a is not the identity."""
    import numpy as np
    rng = np.random.RandomState(seed)
    for op in main.global_block().ops:
        if op.type != "batch_norm":
            continue
        c = scope.find_var(op.input("Scale")[0]).shape[0]
        vals = {"Scale": rng.uniform(0.5, 1.0, c),
                "Bias": rng.normal(0.0, 0.1, c),
                "Mean": rng.normal(0.0, 0.1, c),
                "Variance": rng.uniform(0.5, 1.5, c)}
        for slot, v in vals.items():
            name = op.input(slot)[0]
            scope.set(name, torch.from_numpy(v.astype("float32")).to(
                scope.find_var(name).device))


def phase_serving(torch, fluid, seed, card):
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.serving import InferenceEngine

    log("\n== phase 3: ResNet-50 served through InferenceEngine ==")
    main, startup, prob = build_resnet50(fluid, seed)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    overwrite_bn_stats(main, scope, torch, seed)
    n_fused = fluid.fuse_conv_bn(main)
    if n_fused != KERNEL_CONVS + PLAIN_CONVS:
        fail(f"fuse_conv_bn fused {n_fused} chains, want 53")
    with tempfile.TemporaryDirectory() as d:
        fluid.io.save_inference_model(d, ["img"], [prob], exe,
                                      main_program=main, scope=scope)
        engine = InferenceEngine(d)
        ref_engine = InferenceEngine(d)
        t0 = time.perf_counter()
        engine.warmup()
        log(f"warmup of buckets {engine.buckets}: "
            f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(seed)
    feeds = {n: rng.normal(0, 1, (n, IMAGE, IMAGE, 3)).astype("float32")
             for n in REQUESTS}
    cbk.reset_launches()
    tier.reset_fallback_counts()
    replies, lat = {}, {}
    forwards = 0
    for n in REQUESTS:
        t0 = time.perf_counter()
        replies[n], = engine.infer({"img": feeds[n]})
        lat[n] = (time.perf_counter() - t0) * 1e3
        forwards += -(-n // engine.max_batch)
    launches = cbk.launches
    fallbacks = tier.fallback_counts().get("conv_bn", 0)
    log(f"main path: {forwards} forwards, conv_affine launches {launches}, "
        f"plain-routed fused convs {fallbacks}")
    if launches != KERNEL_CONVS * forwards:
        fail(f"conv_affine launched {launches} times in {forwards} "
             f"forwards, want {KERNEL_CONVS} per forward")
    if fallbacks != PLAIN_CONVS * forwards:
        fail(f"{fallbacks} fused convs took the plain chain in {forwards} "
             f"forwards, want {PLAIN_CONVS} per forward")

    fluid.set_flags({"kernel_tier": "torch"})
    try:
        refs = {n: ref_engine.infer({"img": feeds[n]})[0] for n in REQUESTS}
    finally:
        fluid.set_flags({"kernel_tier": "auto"})
    for n in REQUESTS:
        y, ref = replies[n], refs[n]
        if y.shape != (n, CLASSES) or not np.isfinite(y).all():
            fail(f"batch {n}: reply of shape {y.shape}, finite="
                 f"{np.isfinite(y).all()}")
        if np.abs(y.sum(axis=1) - 1).max() > 1e-4:
            fail(f"batch {n}: softmax rows do not sum to 1")
        rel = np.abs(y - ref).max() / np.abs(ref).max()
        same = (y.argmax(1) == ref.argmax(1)).all()
        log(f"batch {n:3d}: {lat[n]:8.2f} ms | rel err vs kernel_tier=torch "
            f"{rel:.2e} | argmax equal {same} | top prob mean "
            f"{y.max(1).mean():.3f} | {card}")
        if not rel <= REL_LIMIT["float32"] or not same:
            fail(f"batch {n}: reply differs from the plain route "
                 f"(rel {rel:.3e}, argmax equal {same})")

    x32 = {"img": feeds[32]}
    for tier_name, eng in (("auto", engine), ("torch", ref_engine)):
        fluid.set_flags({"kernel_tier": tier_name})
        try:
            eng.infer(x32)
            t0 = time.perf_counter()
            reps = 10
            for _ in range(reps):
                eng.infer(x32)
            ms = (time.perf_counter() - t0) * 1e3 / reps
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
        log(f"bucket 32, kernel_tier={tier_name}: {ms:.2f} ms per request, "
            f"{32e3 / ms:.1f} images/s | {card}")
    log(f"engine stats: {json.dumps(engine.stats())}")
    profile_requests(torch, engine, x32, card)
    return launches


def profile_requests(torch, engine, feed, card, reps=3):
    """Where a bucket-32 request's time goes: device time by kernel from
    torch.profiler over ``reps`` requests, and the device's busy share of
    the host wall time."""
    from torch.profiler import ProfilerActivity, profile
    engine.infer(feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.infer(feed)
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((dev_us / 1e3 / reps, ev.count // reps, ev.key))
    if not rows:
        log("profile: torch.profiler recorded no device time "
            "(device breakdown not measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"\n== profile: bucket-32 request, {reps} requests | {card} ==")
    log(f"wall {wall_ms:.2f} ms per request, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%), idle "
        f"{100 * (1 - busy / wall_ms):.1f}%")
    for ms, count, name in rows[:12]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {name[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "paddle_tpu_torch")):
        fail("run chip_smoke.py from a checkout of the repository: "
             "paddle_tpu_torch/ is missing beside it")
    sys.path.insert(0, repo)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.ops.cuda import build

    log("== phase 1: build ==")
    card = card_line()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log(f"card: {card} | torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}) | {nvcc[-1] if nvcc else 'nvcc ?'}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    for name, (secs, out) in build.build(["conv_affine"]).items():
        log(f"built {name} in {secs:.2f} s")
        for line in out.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"  {line.strip()}")

    totals = phase_kernels(torch, fluid, args.seed)
    launches = phase_serving(torch, fluid, args.seed, card)

    kernels = [{
        "name": "conv_affine", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_affine.cu",
        "replaces": "paddle_tpu/ops/pallas/conv_bn.py:261",
        "launches": launches,
        "max_abs_err": totals["max_abs_err"],
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": totals["bound_by"],
        "library_ms": totals["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
