#!/usr/bin/env python3
"""Serve and train ResNet-50, train the LSTM and GRU text classifiers, the
CTC acoustic model and the word2vec N-gram model through the PyTorch/CUDA
port on one GPU, and hold every hand-written kernel against its plain
PyTorch version.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each of which exits non-zero on a failed check:

1. build    — compile every csrc/*.cu with nvcc, all at once; print the
              card's name and power limit, the torch and nvcc versions, and
              the TF32 switches (both off: every float32 reference is full
              float32).
2. kernels  — every distinct fused conv shape of ResNet-50 at batch 8, in
              float32 and bfloat16, with and without relu: conv_affine,
              conv_bn_train and conv_bn_bwd against their plain versions;
              momentum_arena against its plain version over ResNet-50's
              trainable parameters, nesterov off and on, bitwise. Then, at
              batch 32 in float32, the training kernels' outputs against
              their plain versions again, and each kernel's time per
              forward or step, its plain version's, one PyTorch library
              call computing the same function (a yardstick the port never
              calls) and the least time the card could take.
3. serving  — ResNet-50 (224x224x3, 1000 classes, softmax fetch) built with
              the port's front end, random weights from the seed, BN
              statistics overwritten so the folded affine is not trivial;
              fuse_conv_bn, save_inference_model, InferenceEngine, warmup;
              requests of batch 1, 3, 8, 32 and 40 (the last one chunks),
              each compared with the same bundle served under
              kernel_tier=torch. Each forward must launch conv_affine 49
              times and route 4 convs to the plain op chain.
4. training — ResNet-50 with mean(softmax_with_cross_entropy), fuse_conv_bn
              and Momentum(0.0125, 0.9, fused=True) at batch 32 (bench.py:217
              with its batch-256 rate of 0.1 scaled to batch 32), seeded
              weights; 5 steps on one fixed feed under kernel_tier=auto and
              under kernel_tier=torch, each from a copy of the startup
              state. Each step must launch conv_bn_train and conv_bn_bwd 49
              times each and momentum_arena once, and route 4 + 4 convs to
              the plain chain. The step-1 loss must match the plain route,
              and each parameter's step-1 gradient (each running
              statistic's change) must lie within a limit set by its own
              float32 floor, measured in the run by plain-route steps on
              the batch in permuted orders; a step with a planted fault in
              conv_bn_bwd must break those limits; the loss must fall over
              the 5 steps. Prints ms per step, images/s and peak memory for
              both routes, the relu outputs that change side between the
              routes, the losses at bench.py's lr 0.1, and a profile of one
              step.
5. lstm     — lstm_seq and lstm_seq_bwd (b 64, L 100, H 512, ragged) and
              adam_arena (bitwise) against their plain versions; times.
6. textcls  — bench.py:239's LSTM text classifier at its published widths,
              5 steps on both routes: 2 + 2 + 1 launches and 0 plain-routed
              LSTMs per step; step 1 on a fixed and a ragged feed held to
              the same program with the LSTM wrappers' plain versions; a
              planted dW fault must be caught; the loss must fall.
7. gru, ctc — gru_seq and gru_seq_bwd at the lane's shape (ragged), also
              measured against the same recipe in float64; ctc_alpha and
              ctc_loss_bwd at the CTC model's shape; times, bounds, the
              GRU's serial floor and F.ctc_loss as a yardstick.
8. gru cls  — bench.py:320's GRU text classifier as phase 6 runs the LSTM
              one: 2 + 2 + 1 launches and 0 plain-routed GRUs per step.
9. ctc      — tests/book/test_ocr_ctc.py's CTC acoustic model at
              DeepSpeech2's widths (161 features, hidden 512, 28 + 1
              classes, 64 utterances of 100-200 frames), 5 steps on both
              routes: 1 launch each of gru_seq, gru_seq_bwd, ctc_alpha,
              ctc_loss_bwd and adam_arena per step; step 1 held to the
              plain versions; a planted dlogits fault must be caught; then
              greedy decoding through main.clone(for_test=True) and
              edit_distance.
10. sparse   — embedding_sgd against its plain version, bitwise, at
              word2vec's table (2073 x 32, 128 Zipf-skewed ids with
              duplicates and sentinel entries) and at a CTR-scale table
              (a Criteo batch of 4096: one Zipf-drawn value of each of the
              26 categorical fields from the field's own vocabulary,
              hashed into one 1 000 000 x 64 table, 106 496 ids); an
              all-sentinel call is the identity and untouched rows stay
              bitwise; sgd_arena against its plain version, bitwise, over
              word2vec's dense parameters and ResNet-50's. Times, unique
              rows, bounds, and w.index_add_ and SGD(fused=True).step as
              yardsticks.
11. word2vec — tests/book/test_word2vec.py's N-gram model at the reference
              book test's widths (dict 2073, 4 context words, embedding 32,
              hidden 256, batch 32) with is_sparse=True and
              SGD(0.001, fused=True), Zipf-skewed ids and seeded weights;
              5 steps on one batch on both routes: 1 embedding_sgd and 1
              sgd_arena launch and 0 plain-routed updates per step; step 1
              bitwise the same program with the plain-version wrappers,
              within float32 roundings of the unmerged scatter route; rows
              absent from the batch unchanged; a planted lr fault in
              embedding_sgd must be caught; the loss must fall.

The last three lines of output are a JSON line listing each kernel's
numbers, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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

# relu masks in the kernel-vs-plain checks: where the plain pre-activation
# lies within this share of its largest magnitude of 0, dy is set to 0, so
# that neither version's mask there is decided by a rounding (the two sum
# the conv in different orders; a pre-activation within one rounding of 0
# may take the other side of the relu, which moves dbias by a whole dy term)
MASK_MARGIN = 1e-3

# phase 4, kernel route vs plain route on step 1. Loss: both compute the
# same float32 function with sums in other orders through 53 conv+BN
# layers, which moves the loss by float32 roundings (~1e-7 relative), so
# 1e-4 is loose for that and tight for a wrong kernel.
# Parameters: each trainable parameter's step-1 gradient and each running
# statistic's step-1 change, ‖Δ‖₂/‖ref‖₂, within FLOOR_FACTOR times that
# parameter's own float32 floor, and never below REL_MIN (for a floor of
# 0). The floor is the largest such spread between the plain route and the
# plain route on the same batch in FLOOR_ORDERS permuted orders, the same
# function summed in other orders. It lies far above float32's rounding:
# ResNet-50 with batch statistics amplifies a rounding through its layers,
# and a relu output within a rounding of 0 takes either side whichever
# route runs. The check's reach is shown in every run: a kernel-route step
# whose conv_bn_bwd scales one layer's dw and another's dscale by PLANTED,
# at the layers whose limits are loosest, must exceed the limits, and a
# plain-route step in a further order is printed against them.
LOSS_LIMIT, FLOOR_FACTOR, FLOOR_ORDERS, REL_MIN = 1e-4, 2.0, 3, 1e-5
PLANTED = 0.875

IMAGE, CLASSES = 224, 1000
REQUESTS = (1, 3, 8, 32, 40)
KERNEL_CONVS, PLAIN_CONVS = 49, 4
TRAIN_BATCH, TRAIN_STEPS = 32, 5
# bench.py:217 trains with lr 0.1 at its default batch of 256; at batch 32
# that rate makes the loss on one fixed feed climb after step 2 on both
# routes alike (phase 4 prints it), so phase 4 takes the linear-scaling
# rate 0.1 * 32 / 256
BENCH_LR = 0.1
TRAIN_LR = BENCH_LR * TRAIN_BATCH / 256
KERNELS = ("conv_affine", "conv_bn_train", "conv_bn_bwd", "optimizer_arena",
           "lstm_seq", "gru_seq", "ctc", "embedding_sgd")

# phases 5-6: bench.py:239's lane (benchmark/README.md:115-127)
SEQ_BATCH, SEQ_LEN, SEQ_HIDDEN, SEQ_VOCAB, SEQ_EMB = 64, 100, 512, 30000, 128
SEQ_LR, SEQ_STEPS = 2e-3, 5
# lstm_seq vs lstm_seq_torch, ‖Δ‖∞/‖ref‖∞: the kernel sums the same exact
# bf16 x bf16 products in float32 (in another order) and applies the same
# sigmoid and tanh, so the carries agree to float32 roundings compounded
# over 100 steps; 1e-5 is loose for that and tight for a wrong kernel
LSTM_FWD_LIMIT = 1e-5
# lstm_seq_bwd vs lstm_seq_bwd_torch: each step's dW_t and the product part
# of dh_{t-1} are rounded to bfloat16 (the reference's vjp does so). A
# float32 rounding of difference before them carries an element across a
# bf16 rounding boundary now and then, which moves it by one bf16 step,
# 2^-8 = 3.9e-3 of itself, and a moved dh travels back through the steps
# before it. So ‖Δ‖∞/‖ref‖∞ may reach a few bf16 steps of the largest
# element (1e-2 allows ~2.5), while such elements stay rare, which
# ‖Δ‖₂/‖ref‖₂ ≤ 2e-3 holds
LSTM_BWD_LIMIT, LSTM_BWD_L2_LIMIT = 1e-2, 2e-3
# phase 6, the kernel route's step 1 against the same program with the two
# LSTM wrappers swapped for their plain versions. Loss, relative: the
# forward kernel agrees with its plain version to float32 roundings
# (phase 5), and nothing else differs. Gradients, ‖Δ‖₂/‖ref‖₂ per
# parameter: every gradient at or below an LSTM carries the LSTM
# backward's rare bf16 rounding moves, which phase 5 holds to
# LSTM_BWD_L2_LIMIT on each output; a permuted batch on the plain route
# moves far fewer of them (it reorders only the batch sums of dW), so it
# is no floor for this check. A step whose lstm_seq_bwd scales one dW by
# PLANTED must exceed the limit
TEXTCLS_LOSS_LIMIT, TEXTCLS_GRAD_LIMIT = 1e-5, LSTM_BWD_L2_LIMIT

# phases 7-9: bench.py:320's GRU lane at phases 5-6's widths, and the CTC
# acoustic model of tests/book/test_ocr_ctc.py:38-50 at DeepSpeech2's
# widths: 161 features (a linear spectrogram of 20 ms windows at a 10 ms
# stride, 16 kHz), the lane's hidden 512, 28 characters (26 letters, space,
# apostrophe) plus the blank; 64 utterances of 100-200 frames (1-2 s) with
# labels of ⌈frames/8⌉..⌊frames/4⌋ characters. Adam at the lanes' 2e-3: at
# the book test's 0.01, which it takes at hidden 24, the loss swings on a
# fixed batch at these widths (402 -> 137 -> 636 -> 283 -> 242 on both
# routes, an H100 run)
CTC_BATCH, CTC_FEAT, CTC_HIDDEN, CTC_CLASSES = 64, 161, 512, 28
CTC_FRAMES, CTC_LR = (100, 200), 2e-3
# gru_seq vs gru_seq_torch. Unlike the LSTM's, a GRU step rounds a product
# of its own sums to bf16 inside the step (bf16(r ⊙ h) · W_c): where the
# two sum r's product in another float32 order, r moves by a float32 step
# now and then, that moves bf16(r ⊙ h) across a rounding boundary by 2^-8
# of itself, and the candidate of every unit moves with it; later steps
# carry it on. So the carries agree to a few such moves, ‖Δ‖∞/‖ref‖∞ ≤ 1e-2
# and ‖Δ‖₂/‖ref‖₂ ≤ 2e-3 (PERF.md §6 gives the H100 readings at L 100),
# and neither is nearer the truth: each version's ‖Δ‖∞ to the same recipe
# in float64 must be within GRU_F64_RATIO of the other's
GRU_FWD_LIMIT, GRU_FWD_L2_LIMIT, GRU_F64_RATIO = 1e-2, 2e-3, 2.0
# gru_seq_bwd vs gru_seq_bwd_torch: the LSTM backward's reasoning, with
# four bf16 roundings a step where the LSTM has two (both dh products and
# both parts of dW_t), so twice its ‖Δ‖₂ allowance
GRU_BWD_LIMIT, GRU_BWD_L2_LIMIT = 1e-2, 4e-3
# ctc_alpha vs ctc_alpha_torch: the same operations in the same order
# (logaddexp as max + log1p(exp(-|d|)), each rounded), so equal to float32
# roundings of exp and log1p at most. ctc_loss_bwd vs ctc_loss_bwd_torch:
# the kernel adds each state's three cotangents and scatters the emission
# cotangents onto the classes in its own order, autograd in another, and
# the difference travels back through up to 200 steps of logaddexp
# weights: float32 roundings only, 1e-4 of the largest element
CTC_FWD_LIMIT, CTC_BWD_LIMIT = 1e-5, 1e-4
# phases 8-9, the kernel route's step 1 against the same program with the
# GRU (and CTC) wrappers swapped for their plain versions. Both GRU
# kernels differ from their plain versions by bf16 rounding moves (above),
# the forward's now moving the activations too, so the loss may move by
# ~1e-5 and each gradient ‖Δ‖₂/‖ref‖₂ by a few 1e-3; 1e-4 and 1e-2 allow
# that, and a gradient scaled by PLANTED moves by 0.125, 12x the limit
GRU_TRAIN_LOSS_LIMIT, GRU_TRAIN_GRAD_LIMIT = 1e-4, 1e-2

# phases 10-11: tests/book/test_word2vec.py's N-gram model at the reference
# book test's published widths: a dictionary of 2073 words (PTB at
# imikolov.build_dict()'s min_word_freq 50), N 5 (4 context words),
# embedding 32, hidden 256, batch 32, SGD(0.001), is_sparse=True
W2V_DICT, W2V_N, W2V_EMB, W2V_HIDDEN, W2V_BATCH = 2073, 5, 32, 256, 32
W2V_LR, W2V_STEPS = 1e-3, 5
# phase 11 holds step 1 of the kernel route bitwise to the same program
# with the plain-version wrappers (both kernels are bitwise their plain
# versions, phase 10), and to the unmerged-scatter route within (longest
# run + 1) float32 steps of the table's largest value. On an NVIDIA H100
# 80GB HBM3 at 700.00 W (--seed 0): bitwise; 0.0 steps from the scatter
# route (limit 21, a run of 20); lr x0.875 planted in the step's
# embedding_sgd launch moved shared_w by 111.0 steps
# word ids, and each categorical field's values, are drawn with
# rank-frequency 1/rank^ZIPF_S. An assumption: Zipf's law puts word
# frequencies near exponent 1, and no source at hand gives the Criteo
# fields' value frequencies
ZIPF_S = 1.1
# phase 10's word2vec-shaped call: one step's 4 x 32 entries, W2V_SENTINELS
# of them sentinels (as padded LoD positions give)
W2V_SENTINELS = 8
# phase 10's CTR-scale call: a Criteo display-ads batch of 4096 examples,
# one value of each of its 26 categorical fields, drawn from that field's
# own vocabulary and hashed with the field's index into one table of
# 1 000 000 rows of 64 float32. The vocabularies' sizes are the Kaggle
# data's distinct values per field (C1..C26), as TorchRec's DLRM example
# passes them in --num_embeddings_per_feature
CRITEO_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                 93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652,
                 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
CTR_BATCH, CTR_ROWS, CTR_DIM = 4096, 1_000_000, 64


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
    launches = cbk.launches["conv_affine"]
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
    profile(torch, lambda: engine.infer(x32), "bucket-32 request", card)
    return launches


def profile(torch, fn, title, card, reps=3):
    """Where the time of ``fn`` goes: device time by kernel from
    torch.profiler over ``reps`` calls, and the device's busy share of the
    host wall time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
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
    log(f"\n== profile: {title}, {reps} calls | {card} ==")
    log(f"wall {wall_ms:.2f} ms per call, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%), idle "
        f"{100 * (1 - busy / wall_ms):.1f}%")
    for ms, count, name in rows[:14]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {name[:90]}")


EPS = 1e-5


def build_resnet50_train(fluid, seed):
    """bench.py:217 build(fuse=True) at its published widths: ResNet-50,
    mean(softmax_with_cross_entropy), fuse_conv_bn, then
    Momentum(TRAIN_LR, 0.9, fused=True).minimize."""
    from paddle_tpu_torch.testing.models import resnet
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[IMAGE, IMAGE, 3])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            resnet(img, CLASSES), label))
        n_fused = fluid.fuse_conv_bn(main)
        if n_fused != KERNEL_CONVS + PLAIN_CONVS:
            fail(f"fuse_conv_bn fused {n_fused} chains, want 53")
        fluid.optimizer.Momentum(learning_rate=TRAIN_LR, momentum=0.9,
                                 fused=True).minimize(loss, startup)
    return main, startup, loss


def bn_work(x, w, strides, paddings, itemsize, backward):
    """(operations, bytes) of one conv_bn_train or conv_bn_bwd call. The
    forward: one conv (2·M·Cout·K) and ~6 operations per output element
    (statistics, normalize, relu); x and w read, y written. The backward:
    three GEMMs of the conv's size (z, dw, dx) and ~12 operations per
    output element; x, w and dy read, dx and dw (float32) written."""
    n, h, wd, cin = x
    cout, _, kh, kw = w
    ho = (h + 2 * paddings[0] - kh) // strides[0] + 1
    wo = (wd + 2 * paddings[1] - kw) // strides[1] + 1
    m = n * ho * wo
    gemm = 2 * m * cout * kh * kw * cin
    xb, wb, yb = n * h * wd * cin * itemsize, cout * cin * kh * kw * 4, \
        m * cout * itemsize
    if backward:
        return 3 * gemm + 12 * m * cout, 2 * xb + wb + yb + wb + 4 * cout * 4
    return gemm + 6 * m * cout, xb + wb + yb + 4 * cout * 4


def bound_ms(ops, nbytes, dtype="float32"):
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def phase_train_kernels(torch, fluid, seed):
    """conv_bn_train, conv_bn_bwd and momentum_arena against their plain
    versions, then their times per training step at batch 32 in float32.
    Returns {kernel: numbers for the kernels line}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    main, _, _ = build_resnet50_train(fluid, seed)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def operands(x_shape, w_shape, dtype):
        cout, cin, kh, kw = w_shape
        return (randn(x_shape).to(dtype),
                randn(w_shape, (2.0 / (cin * kh * kw)) ** 0.5),
                torch.rand(cout, generator=gen, device=dev) + 0.5,
                randn((cout,), 0.1))

    shapes8 = fused_conv_shapes(fluid, main, 8)
    geoms = sorted({k[:4] for k in shapes8 if cbk.supported(
        k[0], k[1], k[2], k[3], k[4], k[5], "NHWC", "float32")},
        key=lambda g: (-g[0][1], g[1][1], g[1][0], g[2]))
    log(f"\n== phase 2: conv_bn_train / conv_bn_bwd vs their plain "
        f"versions, {len(geoms)} distinct shapes, batch 8 ==")
    out = {k: {"max_abs_err": 0.0} for k in
           ("conv_bn_train", "conv_bn_bwd", "momentum_arena")}
    errs = {}

    def check(kernel, names, got, ref, what, dname):
        for name, g, r in zip(names, got, ref):
            if g.shape != r.shape or g.dtype != r.dtype:
                fail(f"{kernel} {what} {name}: got {tuple(g.shape)}/"
                     f"{g.dtype}, want {tuple(r.shape)}/{r.dtype}")
            d = (g.float() - r.float()).abs().max().item()
            rel = d / max(r.float().abs().max().item(), 1e-30)
            if dname == "float32":
                out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"],
                                                 d)
            key = (kernel, what[0], what[1], dname)
            errs[key] = max(errs.get(key, 0.0), rel)
            if not rel <= REL_LIMIT[dname]:
                fail(f"{kernel} {what} {dname} {name}: rel err {rel:.3e} > "
                     f"{REL_LIMIT[dname]:.0e}")

    def masked_dy(x, w, scale, bias, strides, paddings, act):
        """A random dy, zero where a relu's plain pre-activation lies within
        MASK_MARGIN of 0 (see MASK_MARGIN)."""
        y = cbk.conv_bn_train_torch(x, w, scale, bias, EPS, strides,
                                    paddings, "")[0]
        dy = randn(y.shape)
        if act == "relu":
            pre = y.float().abs()
            dy = dy * (pre > MASK_MARGIN * pre.max())
        return dy.to(x.dtype)

    def check_pair(x, w, scale, bias, dy, strides, paddings, act, dname):
        """Both training kernels against their plain versions on one set
        of operands; returns the plain forward's (mean, var)."""
        what = (tuple(x.shape), tuple(w.shape), strides)
        args = (EPS, strides, paddings, act)
        got = cbk.conv_bn_train(x, w, scale, bias, *args)
        torch.cuda.synchronize()
        ref = cbk.conv_bn_train_torch(x, w, scale, bias, *args)
        check("conv_bn_train", ("y", "mean", "var"), got, ref, what, dname)
        mean, var = ref[1], ref[2]
        got = cbk.conv_bn_bwd(x, w, dy, scale, bias, mean, var, *args)
        torch.cuda.synchronize()
        ref = cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, mean, var, *args)
        check("conv_bn_bwd", ("dx", "dw", "dscale", "dbias"), got, ref,
              what, dname)
        return mean, var

    for x_shape, w_shape, strides, paddings in geoms:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            for act in ("", "relu"):
                x, w, scale, bias = operands(x_shape, w_shape, dtype)
                dy = masked_dy(x, w, scale, bias, strides, paddings, act)
                check_pair(x, w, scale, bias, dy, strides, paddings, act,
                           dname)

    params = [p for p in main.global_block().all_parameters() if p.trainable]
    log(f"\n== phase 2: momentum_arena vs momentum_arena_torch over "
        f"ResNet-50's {len(params)} trainable parameters "
        f"({sum(_numel(p.shape) for p in params)} elements), bitwise ==")
    ps = [randn(p.shape) for p in params]
    gs = [randn(p.shape) for p in params]
    vs = [randn(p.shape) for p in params]
    lr = torch.full((), 0.1, device=dev)
    for nesterov in (False, True):
        want_p, want_v = opk.momentum_arena_torch(ps, gs, vs, lr, 0.9,
                                                  nesterov)
        got_p, got_v = opk.momentum_arena([p.clone() for p in ps], gs,
                                          [v.clone() for v in vs], lr, 0.9,
                                          nesterov)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip(got_p + got_v, want_p + want_v)):
            diff = max((a - b).abs().max().item() for a, b in
                       zip(got_p + got_v, want_p + want_v))
            fail(f"momentum_arena (nesterov={nesterov}) differs from "
                 f"momentum_arena_torch: max abs {diff:.3e}, want bitwise")
        log(f"nesterov={nesterov}: bitwise equal")

    log(f"\n== conv_bn_train / conv_bn_bwd at batch {TRAIN_BATCH}, "
        "float32, per shape: outputs against the plain versions, then "
        "times ==")
    log("  x[N,H,W,C] w[O,I,kh,kw] s act n/step | rel_err f32@8 bf16@8 "
        f"f32@{TRAIN_BATCH} (train; bwd) | kernel_ms plain_ms library_ms "
        "bound_ms, forward; backward")
    for k in ("conv_bn_train", "conv_bn_bwd"):
        out[k].update(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      ops=0, bytes=0)
    shapes32 = fused_conv_shapes(fluid, main, TRAIN_BATCH)
    for key, count in sorted(shapes32.items(),
                             key=lambda kv: (-kv[0][0][1], kv[0][1][1],
                                             kv[0][1][0], kv[0][2])):
        x_shape, w_shape, strides, paddings, _, _, act = key
        if not cbk.supported(x_shape, w_shape, strides, paddings, (1, 1), 1,
                             "NHWC", "float32"):
            continue
        x, w, scale, bias = operands(x_shape, w_shape, torch.float32)
        args = (EPS, strides, paddings, act)
        dy = masked_dy(x, w, scale, bias, strides, paddings, act)
        mean, var = check_pair(x, w, scale, bias, dy, strides, paddings, act,
                               "float32")
        rm = torch.zeros_like(scale)
        rv = torch.ones_like(scale)
        leaves = [t.detach().requires_grad_(True) for t in
                  (x.permute(0, 3, 1, 2), w, scale, bias)]

        def composite(xn, wn, sc, bi):
            y = F.batch_norm(F.conv2d(xn, wn, stride=strides,
                                      padding=paddings),
                             rm, rv, sc, bi, training=True, eps=EPS)
            return F.relu(y) if act == "relu" else y

        with torch.enable_grad():
            y_lib = composite(*leaves)
        dy_n = dy.permute(0, 3, 1, 2)
        rows = {}
        for kname, kfn, pfn, lfn in (
                ("conv_bn_train",
                 lambda: cbk.conv_bn_train(x, w, scale, bias, *args),
                 lambda: cbk.conv_bn_train_torch(x, w, scale, bias, *args),
                 lambda: composite(*[t.detach() for t in leaves])),
                ("conv_bn_bwd",
                 lambda: cbk.conv_bn_bwd(x, w, dy, scale, bias, mean, var,
                                         *args),
                 lambda: cbk.conv_bn_bwd_torch(x, w, dy, scale, bias, mean,
                                               var, *args),
                 lambda: torch.autograd.grad(y_lib, leaves, dy_n,
                                             retain_graph=True))):
            ops, nbytes = bn_work(x_shape, w_shape, strides, paddings, 4,
                                  kname == "conv_bn_bwd")
            b_ms, _by = bound_ms(ops, nbytes)
            rows[kname] = (time_ms(kfn, torch), time_ms(pfn, torch),
                           time_ms(lfn, torch), b_ms)
            t = out[kname]
            for field, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                                rows[kname]):
                t[field] += count * v
            t["ops"] += count * ops
            t["bytes"] += count * nbytes
        x8 = (8,) + x_shape[1:]
        e = [errs.get((k, xs, w_shape, d), 0.0)
             for k in ("conv_bn_train", "conv_bn_bwd")
             for xs, d in ((x8, "float32"), (x8, "bfloat16"),
                           (x_shape, "float32"))]
        log(f"  {list(x_shape)} {list(w_shape)} {strides[0]} "
            f"{act or '-':4} {count} | {e[0]:.1e} {e[1]:.1e} {e[2]:.1e}; "
            f"{e[3]:.1e} {e[4]:.1e} {e[5]:.1e} | " + "; ".join(
                " ".join(f"{v:.4f}" for v in rows[k])
                for k in ("conv_bn_train", "conv_bn_bwd")))
    for k in ("conv_bn_train", "conv_bn_bwd"):
        t = out[k]
        t["bound_by"] = bound_ms(t["ops"], t["bytes"])[1]
        log(f"  per step at batch {TRAIN_BATCH} (49 convs), {k}: kernel "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, cuDNN "
            f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
            f"({t['ops'] / t['ms'] / 1e9:.1f} TFLOP/s achieved)")

    nelem = sum(p.numel() for p in ps)
    sgd_params = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(sgd_params, gs):
        p.grad = g
    sgd = torch.optim.SGD(sgd_params, lr=0.1, momentum=0.9, fused=True)
    t = out["momentum_arena"]
    t["ms"] = time_ms(lambda: opk.momentum_arena(ps, gs, vs, lr, 0.9, False),
                      torch)
    t["plain_ms"] = time_ms(lambda: opk.momentum_arena_torch(
        ps, gs, vs, lr, 0.9, False), torch)
    t["library_ms"] = time_ms(sgd.step, torch)
    t["bound_ms"], t["bound_by"] = bound_ms(0, 20 * nelem)
    log(f"momentum_arena per step ({len(ps)} tensors, {nelem} elements): "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"SGD(fused=True) {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def copy_scope(fluid, torch, src):
    """A scope holding a copy of every tensor of ``src``."""
    scope = fluid.Scope()
    for name in src.local_names():
        v = src.find_var(name)
        if torch.is_tensor(v):
            scope.set(name, v.clone())
    return scope


def op_counts(block):
    types = {}
    for op in block.ops:
        types[op.type] = types.get(op.type, 0) + 1
    return ", ".join(f"{k}x{v}" for k, v in sorted(types.items()))


def spread(got, ref):
    """{name: ‖got − ref‖₂ / ‖ref‖₂}."""
    return {n: ((got[n].double() - ref[n].double()).norm()
                / ref[n].double().norm().clamp_min(1e-30)).item()
            for n in ref}


def phase_training(torch, fluid, seed, card):
    """Train ResNet-50 5 steps on one feed under both routes and hold step 1
    of the kernel route to the plain route parameter by parameter; returns
    the launches of each training kernel on the kernel route."""
    import re
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.conv_ops import conv_attrs
    from paddle_tpu_torch.ops.cuda import conv_bn as cbk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    log(f"\n== phase 4: ResNet-50 training, batch {TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps on one feed ==")
    main, startup, loss = build_resnet50_train(fluid, seed)
    block = main.global_block()
    log("program: " + op_counts(block))
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)

    def fresh():
        return copy_scope(fluid, torch, init)

    rng = np.random.RandomState(seed)
    feed = {"img": rng.normal(0, 1, (TRAIN_BATCH, IMAGE, IMAGE, 3))
            .astype("float32"),
            "label": rng.randint(0, CLASSES, (TRAIN_BATCH, 1))
            .astype("int64")}
    update, = [op for op in block.ops if op.type == "fused_momentum"]
    grads = dict(zip(update.input("Params"), update.input("Grads")))
    stats = [p.name for p in block.all_parameters() if p.name not in grads]

    def run(route, scope, fd, fetch=()):
        fluid.set_flags({"kernel_tier": route})
        try:
            return exe.run(main, feed=fd, fetch_list=[loss] + list(fetch),
                           scope=scope, return_numpy=False)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})

    def readings(vals, scope):
        """Step 1 per parameter: each trainable parameter's gradient (from
        ``vals``, fetched after the loss) and each running statistic's
        change."""
        out = dict(zip(grads, vals[1:]))
        for n in stats:
            out[n] = scope.find_var(n).double() - init.find_var(n).double()
        return out

    want = {"auto": (KERNEL_CONVS, KERNEL_CONVS, 1, 2 * PLAIN_CONVS),
            "torch": (0, 0, 0, 0)}
    res = {}
    for route in ("auto", "torch"):
        scope = fresh()
        losses, ms, total = [], [], [0, 0, 0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            cbk.reset_launches()
            opk.reset_launches()
            tier.reset_fallback_counts()
            t0 = time.perf_counter()
            vals = run(route, scope, feed, grads.values() if step == 0
                       else ())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = (cbk.launches["conv_bn_train"],
                      cbk.launches["conv_bn_bwd"],
                      opk.launches["momentum_arena"],
                      tier.fallback_counts().get("conv_bn", 0))
            if counts != want[route]:
                fail(f"kernel_tier={route} step {step + 1}: launches "
                     f"conv_bn_train/conv_bn_bwd/momentum_arena and "
                     f"plain-routed convs {counts}, want {want[route]}")
            for i in range(3):
                total[i] += counts[i]
            lv = vals[0]
            if lv.shape != () or not torch.isfinite(lv).item():
                fail(f"kernel_tier={route} step {step + 1}: loss {lv}")
            losses.append(lv.item())
            if step == 0:
                step1 = readings(vals, scope)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = sum(ms[1:]) / len(ms[1:])
        res[route] = dict(losses=losses, step1=step1, total=total)
        log(f"kernel_tier={route}: losses "
            + " ".join(f"{v:.6f}" for v in losses)
            + " | ms/step " + " ".join(f"{v:.1f}" for v in ms)
            + f" | steady {steady:.2f} ms/step, "
            f"{TRAIN_BATCH * 1e3 / steady:.1f} images/s | peak memory "
            f"{peak:.2f} GiB | {card}")

    # the float32 floor: plain-route steps on the batch in other orders;
    # the last order is held out and only printed against the limits
    ref = res["torch"]["step1"]
    floors = []
    for j in range(FLOOR_ORDERS + 1):
        perm = np.random.RandomState(seed + 1 + j).permutation(TRAIN_BATCH)
        scope = fresh()
        vals = run("torch", scope, {k: v[perm] for k, v in feed.items()},
                   grads.values())
        floors.append(spread(readings(vals, scope), ref))
    held_out = floors.pop()
    floor = {n: max(f[n] for f in floors) for n in ref}
    limit = {n: max(REL_MIN, FLOOR_FACTOR * floor[n]) for n in ref}
    got = spread(res["auto"]["step1"], ref)

    def median(vals):
        vals = sorted(vals)
        return vals[len(vals) // 2]

    dl = abs(res["auto"]["losses"][0] - res["torch"]["losses"][0]) \
        / abs(res["torch"]["losses"][0])
    log(f"step 1, kernel vs plain route: loss rel diff {dl:.3e} (limit "
        f"{LOSS_LIMIT:.0e}); per parameter, the gradient of {len(grads)} "
        f"and the running-statistic change of {len(stats)}, ‖Δ‖₂/‖ref‖₂ "
        f"against {FLOOR_FACTOR}x its float32 floor (plain route, batch in "
        f"{FLOOR_ORDERS} other orders):")
    log("  kind           n | kernel vs plain: median, worst/limit | "
        "floor median | held-out order: worst/limit")
    kinds = {}
    for n in ref:
        kinds.setdefault(re.sub(r"_\d+\.", ".", n), []).append(n)
    for kind, names in sorted(kinds.items()):
        log(f"  {kind:12} {len(names):3d} | "
            f"{median(got[n] for n in names):.3e}, "
            f"{max(got[n] / limit[n] for n in names):.3f} | "
            f"{median(floor[n] for n in names):.3e} | "
            f"{max(held_out[n] / limit[n] for n in names):.3f}")
    worst = max(ref, key=lambda n: got[n] / limit[n])
    held = max(ref, key=lambda n: held_out[n] / limit[n])
    log(f"  worst: {worst} {got[worst]:.3e} (limit {limit[worst]:.3e}); "
        f"held-out order's worst: {held} {held_out[held]:.3e} (limit "
        f"{limit[held]:.3e})")
    problems = []
    if not dl <= LOSS_LIMIT:
        problems.append(f"step-1 loss differs from the plain route by "
                        f"{dl:.3e}")
    over = [n for n in ref if not got[n] <= limit[n]]
    if over:
        problems.append(f"{len(over)} parameters differ from the plain "
                        f"route at step 1 beyond their limits, worst "
                        f"{worst} {got[worst]:.3e} > {limit[worst]:.3e}")

    # the check's own test: a kernel-route step whose conv_bn_bwd scales
    # one layer's dw and another layer's dscale by PLANTED, at the layers
    # whose limits are loosest, must exceed those limits
    launched = []      # (filter, scale) of each conv_bn_bwd launch, in order
    for op in block.ops:
        if op.type != "fused_conv2d_bn_grad":
            continue
        x = (TRAIN_BATCH,) + tuple(block.var(op.input("Input")[0]).shape[1:])
        w = tuple(block.var(op.input("Filter")[0]).shape)
        if cbk.supported(x, w, *conv_attrs(op.attr), "NHWC", "float32"):
            launched.append((op.input("Filter")[0], op.input("Scale")[0]))
    at_dw = max(range(len(launched)), key=lambda i: limit[launched[i][0]])
    at_ds = max(range(len(launched)), key=lambda i: limit[launched[i][1]])
    real, calls = cbk.conv_bn_bwd, [0]

    def planted(*args):
        dx, dw, dscale, dbias = real(*args)
        dw = dw * PLANTED if calls[0] == at_dw else dw
        dscale = dscale * PLANTED if calls[0] == at_ds else dscale
        calls[0] += 1
        return dx, dw, dscale, dbias

    cbk.conv_bn_bwd = planted
    try:
        scope = fresh()
        bad = spread(readings(run("auto", scope, feed, grads.values()),
                              scope), ref)
    finally:
        cbk.conv_bn_bwd = real
    if calls[0] != len(launched):
        problems.append(f"the planted step made {calls[0]} conv_bn_bwd "
                        f"calls, want {len(launched)}")
    for what, i, name in (("dw", at_dw, launched[at_dw][0]),
                          ("dscale", at_ds, launched[at_ds][1])):
        log(f"planted fault: {what} x{PLANTED} at conv_bn_bwd launch "
            f"{i + 1} ({name}): ‖Δ‖₂/‖ref‖₂ {bad[name]:.3e}, limit "
            f"{limit[name]:.3e}")
        if not bad[name] > limit[name]:
            problems.append(f"the parameter check does not see {what} "
                            f"x{PLANTED} at {name}")

    # bench.py's own rate, and how many relu outputs change side at step 1
    lr_name = update.input("LearningRate")[0]
    relus = [op.output("Output")[0] for op in block.ops
             if op.type == "fused_conv2d_bn" and op.attr("act") == "relu"]
    relus += [op.output("Out")[0] for op in block.ops if op.type == "relu"]
    fast = {}
    for route in ("auto", "torch"):
        scope = fresh()
        scope.set(lr_name, torch.full_like(init.find_var(lr_name), BENCH_LR))
        vals = run(route, scope, feed, relus)
        masks = [v > 0 for v in vals[1:]]
        losses = [vals[0].item()] + [run(route, scope, feed)[0].item()
                                     for _ in range(TRAIN_STEPS - 1)]
        fast[route] = (losses, masks)
    flips = sum(int((a != b).sum().item()) for a, b in
                zip(fast["auto"][1], fast["torch"][1]))
    log(f"step 1: {flips} of {sum(m.numel() for m in masks)} relu outputs "
        f"are positive on one route and not on the other")
    log(f"at bench.py's lr {BENCH_LR} (its batch 256): losses, kernel route "
        + " ".join(f"{v:.4f}" for v in fast["auto"][0]) + "; plain route "
        + " ".join(f"{v:.4f}" for v in fast["torch"][0]))
    del fast, masks

    for route in ("auto", "torch"):
        losses = res[route]["losses"]
        if not losses[-1] < losses[0]:
            problems.append(f"kernel_tier={route}: loss did not fall over "
                            f"{TRAIN_STEPS} steps on one feed: {losses}")
    if problems:
        fail("; ".join(problems))
    scope = fresh()
    profile(torch, lambda: run("auto", scope, feed),
            f"one training step, batch {TRAIN_BATCH}, kernel route", card,
            reps=2)
    return dict(zip(("conv_bn_train", "conv_bn_bwd", "momentum_arena"),
                    res["auto"]["total"]))


def build_textcls(fluid, seed, cell="lstm"):
    """bench.py:239 build_lstm_textcls (``cell="lstm"``) or bench.py:320
    build_gru_textcls (``"gru"``) at the published widths, with
    Adam(SEQ_LR, fused=True)."""
    from paddle_tpu_torch.testing import models
    net = {"lstm": models.lstm_textcls, "gru": models.gru_textcls}[cell]
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        prob = net(words, vocab=SEQ_VOCAB, emb=SEQ_EMB, hidden=SEQ_HIDDEN)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam(learning_rate=SEQ_LR, fused=True).minimize(
            loss, startup)
    return main, startup, loss


def lstm_operands(torch, gen, dev, lens):
    """x, alive, w, h0, c0, dhs, dcs at phase 5's shape; w at the scale
    of the model's Xavier init, the cotangents zero where alive is 0."""
    L, b, H = SEQ_LEN, SEQ_BATCH, SEQ_HIDDEN
    alive = (torch.arange(L, device=dev)[:, None] < lens[None, :]) \
        .float()[..., None].contiguous()

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (randn(L, b, 4 * H), alive, randn(H, 4 * H, scale=0.05),
            randn(b, H), randn(b, H), (randn(L, b, H) * alive).contiguous(),
            (randn(L, b, H) * alive).contiguous())


def rel_errs(got, ref):
    """(‖Δ‖∞/‖ref‖∞, ‖Δ‖₂/‖ref‖₂, ‖Δ‖∞)."""
    d = (got.double() - ref.double())
    return (d.abs().max().item() / max(ref.abs().max().item(), 1e-30),
            (d.norm() / ref.double().norm().clamp_min(1e-30)).item(),
            d.abs().max().item())


def phase_rnn_kernels(torch, fluid, seed, card):
    """lstm_seq, lstm_seq_bwd and adam_arena against their plain versions
    at the lane's shapes, then their times. Returns {kernel: numbers for
    the kernels line}."""
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    L, b, H = SEQ_LEN, SEQ_BATCH, SEQ_HIDDEN
    lens = torch.randint(1, L + 1, (b,), generator=gen, device=dev)
    lens[: b // 4] = L
    x, alive, w, h0, c0, dhs, dcs = lstm_operands(torch, gen, dev, lens)
    log(f"\n== phase 5: lstm_seq / lstm_seq_bwd vs their plain versions, "
        f"b {b}, L {L}, H {H}, lengths {int(lens.min())}..{int(lens.max())} "
        f"({int((lens == L).sum())} full) ==")
    out = {}
    hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
    torch.cuda.synchronize()
    ref = rnn.lstm_seq_torch(x, alive, w, h0, c0)
    worst = 0.0
    for name, g, r in zip(("hs", "cs"), (hs, cs), ref):
        inf, l2, d = rel_errs(g, r)
        worst = max(worst, d)
        log(f"  lstm_seq {name}: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
            f"{LSTM_FWD_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {l2:.3e}")
        if not inf <= LSTM_FWD_LIMIT:
            fail(f"lstm_seq {name} differs from lstm_seq_torch: {inf:.3e}")
    out["lstm_seq"] = {"max_abs_err": worst}
    # the backward from the plain carries, so that it is held alone
    got = rnn.lstm_seq_bwd(x, alive, w, h0, c0, *ref, dhs, dcs)
    torch.cuda.synchronize()
    want = rnn.lstm_seq_bwd_torch(x, alive, w, h0, c0, *ref, dhs, dcs)
    worst = 0.0
    for name, g, r in zip(("dx", "dw", "dh0", "dc0"), got, want):
        inf, l2, d = rel_errs(g, r)
        worst = max(worst, d)
        log(f"  lstm_seq_bwd {name}: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
            f"{LSTM_BWD_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {l2:.3e} (limit "
            f"{LSTM_BWD_L2_LIMIT:.0e})")
        if not (inf <= LSTM_BWD_LIMIT and l2 <= LSTM_BWD_L2_LIMIT):
            fail(f"lstm_seq_bwd {name} differs from lstm_seq_bwd_torch: "
                 f"{inf:.3e} / {l2:.3e}")
    out["lstm_seq_bwd"] = {"max_abs_err": worst}

    main, _, _ = build_textcls(fluid, seed)
    params = [p for p in main.global_block().all_parameters() if p.trainable]
    nelem = sum(_numel(p.shape) for p in params)
    log(f"\n== phase 5: adam_arena vs adam_arena_torch over the text "
        f"classifier's {len(params)} trainable tensors ({nelem} elements), "
        f"bitwise ==")
    ps = [torch.randn(p.shape, generator=gen, device=dev) * 0.05
          for p in params]
    gs = [torch.randn(p.shape, generator=gen, device=dev) * 1e-2
          for p in params]
    state = {route: ([p.clone() for p in ps],
                     [torch.zeros_like(p) for p in ps],
                     [torch.zeros_like(p) for p in ps])
             for route in ("kernel", "plain")}
    lr = torch.full((1,), SEQ_LR, device=dev)
    pows = [torch.full((1,), 0.9, device=dev),
            torch.full((1,), 0.999, device=dev)]
    for step in (1, 2, 3):
        args = (lr, *pows, 0.9, 0.999, 1e-8)
        k = state["kernel"]
        opk.adam_arena(k[0], gs, k[1], k[2], *args)
        state["plain"] = opk.adam_arena_torch(*state["plain"][:1], gs,
                                              *state["plain"][1:], *args)
        torch.cuda.synchronize()
        pairs = [(a, r) for ks, rs in zip(state["kernel"], state["plain"])
                 for a, r in zip(ks, rs)]
        if step in (1, 3):
            if not all(torch.equal(a, r) for a, r in pairs):
                diff = max((a - r).abs().max().item() for a, r in pairs)
                fail(f"adam_arena differs from adam_arena_torch at step "
                     f"{step}: max abs {diff:.3e}, want bitwise")
            log(f"step {step}: bitwise equal (params and both moments)")
        pows = [pows[0] * 0.9 + 0.0, pows[1] * 0.999 + 0.0]
    out["adam_arena"] = {"max_abs_err": 0.0}

    log(f"\n== phase 5: times at the lane's shapes | {card} ==")
    lstm = torch.nn.LSTM(H, H).to(dev)
    xin = torch.randn(L, b, H, generator=gen, device=dev, requires_grad=True)
    with torch.enable_grad():
        y_lib, _ = lstm(xin)
    dy = torch.randn(y_lib.shape, generator=gen, device=dev)
    lib_leaves = [xin] + list(lstm.parameters())

    def lib_fwd():
        with torch.no_grad():
            lstm(xin)

    # operations of one lstm_seq: the gate product (bf16 operands) and
    # ~30 per cell; bytes: x, alive, w, h0, c0 read, hs and cs written
    gemm = 2 * L * b * H * 4 * H
    fwd_bytes = 4 * (L * b * 4 * H + L * b + 4 * H * H + 2 * b * H
                     + 2 * L * b * H)
    t_ops = gemm / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = fwd_bytes / PEAK_BYTES * 1e3
    out["lstm_seq"].update(
        ms=time_ms(lambda: rnn.lstm_seq(x, alive, w, h0, c0), torch),
        plain_ms=time_ms(lambda: rnn.lstm_seq_torch(x, alive, w, h0, c0),
                         torch),
        library_ms=time_ms(lib_fwd, torch),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    # the backward: the gate product again (bf16 operands), then dW and dh
    # (float32 dgates against bf16 values: float32 operations); bytes: the
    # forward's inputs and carries and the cotangents read, dx, dw, dh0
    # and dc0 written
    t_ops = (gemm / PEAK_FLOPS["bfloat16"]
             + 2 * gemm / PEAK_FLOPS["float32"]) * 1e3
    bwd_bytes = 4 * (2 * L * b * 4 * H + L * b + 2 * 4 * H * H + 4 * b * H
                     + 4 * L * b * H)
    t_bytes = bwd_bytes / PEAK_BYTES * 1e3
    out["lstm_seq_bwd"].update(
        ms=time_ms(lambda: rnn.lstm_seq_bwd(x, alive, w, h0, c0, *ref, dhs,
                                            dcs), torch),
        plain_ms=time_ms(lambda: rnn.lstm_seq_bwd_torch(
            x, alive, w, h0, c0, *ref, dhs, dcs), torch),
        library_ms=time_ms(lambda: torch.autograd.grad(
            y_lib, lib_leaves, dy, retain_graph=True), torch),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    serial = time_ms(lambda: rnn.barrier_chain(H // 4, L, dev), torch)
    for k in ("lstm_seq", "lstm_seq_bwd"):
        t = out[k]
        log(f"{k} per launch: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, torch.nn.LSTM {t['library_ms']:.4f} "
            f"ms (with the input GEMM), bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), serial floor {serial:.4f} ms ({L} grid "
            f"barriers over {H // 4} blocks)")

    adam_ps = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(adam_ps, gs):
        p.grad = g
    adam = torch.optim.Adam(adam_ps, lr=SEQ_LR, fused=True)
    k = state["kernel"]
    t = out["adam_arena"]
    t["ms"] = time_ms(lambda: opk.adam_arena(k[0], gs, k[1], k[2], lr,
                                             *pows, 0.9, 0.999, 1e-8), torch)
    t["plain_ms"] = time_ms(lambda: opk.adam_arena_torch(
        k[0], gs, k[1], k[2], lr, *pows, 0.9, 0.999, 1e-8), torch)
    t["library_ms"] = time_ms(adam.step, torch)
    t["bound_ms"], t["bound_by"] = bound_ms(0, 28 * nelem)
    log(f"adam_arena per step ({len(ps)} tensors, {nelem} elements): kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, Adam(fused=True) "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']})")
    return out


def textcls_feeds(fluid, seed, ragged):
    """One batch of SEQ_BATCH sequences fed as the lane feeds it
    (pack_sequences): length SEQ_LEN, or lengths 1..SEQ_LEN (some full)."""
    import numpy as np
    rng = np.random.RandomState(seed + (7 if ragged else 5))
    lens = np.full(SEQ_BATCH, SEQ_LEN)
    if ragged:
        lens = rng.randint(1, SEQ_LEN + 1, SEQ_BATCH)
        lens[:4] = SEQ_LEN
        lens[4] = 1
    seqs = [rng.randint(0, SEQ_VOCAB, (int(n), 1)).astype("int64")
            for n in lens]
    return {"words": fluid.pack_sequences(seqs),
            "label": rng.randint(0, 2, (SEQ_BATCH, 1)).astype("int64")}


def train_phase(torch, fluid, card, spec):
    """Train ``spec["main"]`` SEQ_STEPS steps on the first of
    ``spec["feeds"]`` under both routes, each step's kernel launches and
    plain-routed ops counted against ``spec["want"]``; hold step 1 of the
    kernel route, on every feed, to the same program with the kernel
    wrappers swapped for their plain versions (``spec["swaps"]``) within
    ``spec["loss_limit"]`` and ``spec["grad_limit"]``; a planted fault
    (``spec["plant"]``) must break the gradient limit; the loss must fall on
    both routes. Prints ms per step, sequences/s and peak memory of both
    routes and a profile of a kernel-route step. Returns (the launch
    totals of the kernel route by counter, its trained scope, the
    executor)."""
    import numpy as np
    title, main, loss = spec["title"], spec["main"], spec["loss"]
    block = main.global_block()
    log("program: " + op_counts(block))
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(spec["startup"], scope=init)
    update, = [op for op in block.ops if op.type == "fused_adam"]
    grads = dict(zip(update.input("Params"), update.input("Grads")))
    feeds = spec["feeds"]
    train_name, train_feed = feeds[0]
    labels = [c[0] for c in spec["counters"]]

    def run(route, scope, fd, fetch=()):
        fluid.set_flags({"kernel_tier": route})
        try:
            return exe.run(main, feed=fd, fetch_list=[loss] + list(fetch),
                           scope=scope, return_numpy=False)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})

    def step1(route, fd):
        """(loss, {param: gradient}) of one step from the startup state."""
        vals = run(route, copy_scope(fluid, torch, init), fd, grads.values())
        return vals[0].item(), dict(zip(grads, vals[1:]))

    want = {"auto": spec["want"], "torch": (0,) * len(labels)}
    res = {}
    for route in ("auto", "torch"):
        scope = copy_scope(fluid, torch, init)
        losses, ms, total = [], [], [0] * len(labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(SEQ_STEPS):
            for reset in spec["resets"]:
                reset()
            t0 = time.perf_counter()
            vals = run(route, scope, train_feed, grads.values() if step == 0
                       else ())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = tuple(get() for _, get in spec["counters"])
            if counts != want[route]:
                fail(f"{title}, kernel_tier={route} step {step + 1}: "
                     f"{'/'.join(labels)} {counts}, want {want[route]}")
            total = [a + c for a, c in zip(total, counts)]
            lv = vals[0]
            if lv.shape != () or not torch.isfinite(lv).item():
                fail(f"{title}, kernel_tier={route} step {step + 1}: loss "
                     f"{lv}")
            losses.append(lv.item())
            if step == 0:
                first = dict(zip(grads, vals[1:]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = sum(ms[1:]) / len(ms[1:])
        res[route] = dict(losses=losses, step1=first, total=total,
                          scope=scope)
        log(f"kernel_tier={route}: losses "
            + " ".join(f"{v:.6f}" for v in losses)
            + " | ms/step " + " ".join(f"{v:.1f}" for v in ms)
            + f" | steady {steady:.2f} ms/step, "
            f"{spec['batch'] * 1e3 / steady:.1f} sequences/s | peak memory "
            f"{peak:.2f} GiB | {card}")

    # the reference: the same program with the kernel wrappers swapped for
    # their plain versions, as the planted fault below swaps one
    real = [(m, a, getattr(m, a)) for m, a, _ in spec["swaps"]]
    for m, a, plain in spec["swaps"]:
        setattr(m, a, plain)
    try:
        refs = {name: step1("auto", fd) for name, fd in feeds}
    finally:
        for m, a, fn in real:
            setattr(m, a, fn)

    problems = []
    loss_limit, grad_limit = spec["loss_limit"], spec["grad_limit"]

    def check(name, loss_got, got):
        ref_loss, ref = refs[name]
        dl = abs(loss_got - ref_loss) / abs(ref_loss)
        sp = spread(got, ref)
        log(f"step 1, {name} feed, kernel vs plain versions: loss rel diff "
            f"{dl:.3e} (limit {loss_limit:.0e}); gradients ‖Δ‖₂/‖ref‖₂ "
            f"(limit {grad_limit:.0e}): "
            + ", ".join(f"{n} {v:.3e}" for n, v in sp.items()))
        if not dl <= loss_limit:
            problems.append(f"{title}, {name} feed: loss differs by "
                            f"{dl:.3e}")
        over = [n for n in grads if not sp[n] <= grad_limit]
        if over:
            problems.append(f"{title}, {name} feed: {over} beyond the "
                            f"limit")

    check(train_name, res["auto"]["losses"][0], res["auto"]["step1"])
    for name, fd in feeds[1:]:
        lv, got = step1("auto", fd)
        if not np.isfinite(lv) or not all(torch.isfinite(g).all().item()
                                          for g in got.values()):
            problems.append(f"{title}: the {name} step is not finite "
                            f"(loss {lv})")
        check(name, lv, got)

    # the check's own test: one output of one kernel launch x PLANTED
    plant = spec["plant"]
    module, attr, at = plant["module"], plant["attr"], plant["at"]
    good, calls = getattr(module, attr), [0]

    def planted(*args):
        out = good(*args)
        if calls[0] == at:
            if plant["index"] is None:
                out = out * PLANTED
            else:
                out = tuple(o * PLANTED if i == plant["index"] else o
                            for i, o in enumerate(out))
        calls[0] += 1
        return out

    setattr(module, attr, planted)
    try:
        bad = spread(step1("auto", train_feed)[1], refs[train_name][1])
    finally:
        setattr(module, attr, good)
    name = plant["param"]
    log(f"planted fault: {plant['what']} x{PLANTED} at {attr} launch "
        f"{at + 1}: {name} ‖Δ‖₂/‖ref‖₂ {bad[name]:.3e}, limit "
        f"{grad_limit:.0e}")
    if calls[0] != plant["calls"]:
        problems.append(f"{title}: the planted step made {calls[0]} {attr} "
                        f"calls, want {plant['calls']}")
    if not bad[name] > grad_limit:
        problems.append(f"{title}: the gradient check does not see "
                        f"{plant['what']} x{PLANTED} at {name}")

    # the torch route runs the float32 scans, without the kernels' bf16
    # roundings: another function, so its distance is printed only
    dist = spread(res["torch"]["step1"], refs[train_name][1])
    dl = abs(res["torch"]["losses"][0] - refs[train_name][0]) \
        / abs(refs[train_name][0])
    log("distance of the torch route (float32 scans) from the kernel "
        f"route's reference at step 1: loss {dl:.3e}; ‖Δ‖₂/‖ref‖₂ "
        + ", ".join(f"{n} {v:.2e}" for n, v in dist.items()))
    for route in ("auto", "torch"):
        losses = res[route]["losses"]
        if not losses[-1] < losses[0]:
            problems.append(f"{title}, kernel_tier={route}: loss did not "
                            f"fall over {SEQ_STEPS} steps on one feed: "
                            f"{losses}")
    if problems:
        fail("; ".join(problems))
    scope = copy_scope(fluid, torch, init)
    profile(torch, lambda: run("auto", scope, train_feed),
            f"{title}: one training step, batch {spec['batch']}, kernel "
            "route", card, reps=3)
    return dict(zip(labels, res["auto"]["total"])), res["auto"]["scope"], exe


def phase_textcls(torch, fluid, seed, card, cell="lstm"):
    """Train the LSTM (phase 6) or GRU (phase 8) text classifier 5 steps on
    one feed under both routes and hold step 1 of the kernel route to the
    plain-version route parameter by parameter; returns the launches of
    each kernel on the kernel route."""
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    name = {"lstm": "LSTM", "gru": "GRU"}[cell]
    fwd, bwd = f"{cell}_seq", f"{cell}_seq_bwd"
    log(f"\n== phase {6 if cell == 'lstm' else 8}: {name} text classifier, "
        f"batch {SEQ_BATCH}, length {SEQ_LEN}, {SEQ_STEPS} steps on one "
        f"feed ==")
    main, startup, loss = build_textcls(fluid, seed, cell)
    weights = [op.input("Weight")[0] for op in main.global_block().ops
               if op.type == f"{cell}_grad"]
    loss_limit, grad_limit = {
        "lstm": (TEXTCLS_LOSS_LIMIT, TEXTCLS_GRAD_LIMIT),
        "gru": (GRU_TRAIN_LOSS_LIMIT, GRU_TRAIN_GRAD_LIMIT)}[cell]
    totals, _, _ = train_phase(torch, fluid, card, dict(
        title=f"{name} text classifier", main=main, startup=startup,
        loss=loss, batch=SEQ_BATCH,
        feeds=[("fixed", textcls_feeds(fluid, seed, ragged=False)),
               ("ragged", textcls_feeds(fluid, seed, ragged=True))],
        counters=[(fwd, lambda: rnn.launches[fwd]),
                  (bwd, lambda: rnn.launches[bwd]),
                  ("adam_arena", lambda: opk.launches["adam_arena"]),
                  (f"plain-routed {name}s",
                   lambda: tier.fallback_counts().get(cell, 0))],
        resets=[rnn.reset_launches, opk.reset_launches,
                tier.reset_fallback_counts],
        want=(2, 2, 1, 0),
        swaps=[(rnn, fwd, getattr(rnn, f"{fwd}_torch")),
               (rnn, bwd, getattr(rnn, f"{bwd}_torch"))],
        # dW x PLANTED in the last backward launch of the step (the first
        # layer's)
        plant=dict(module=rnn, attr=bwd, index=1, at=len(weights) - 1,
                   calls=len(weights), param=weights[-1], what="dW"),
        loss_limit=loss_limit, grad_limit=grad_limit))
    return totals


def gru_operands(torch, gen, dev, lens):
    """x, alive, w, h0, dhs at phase 7's shape; w at the scale of the
    model's Xavier init, the cotangents zero where alive is 0."""
    L, b, H = SEQ_LEN, SEQ_BATCH, SEQ_HIDDEN
    alive = (torch.arange(L, device=dev)[:, None] < lens[None, :]) \
        .float()[..., None].contiguous()

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (randn(L, b, 3 * H), alive, randn(H, 3 * H, scale=0.05),
            randn(b, H), (randn(L, b, H) * alive).contiguous())


def gru_float64(torch, x, alive, w, h0):
    """The GRU forward's recipe (bf16(h)·bf16(w), bf16(r⊙h)·bf16(w_c)) in
    float64: the yardstick both float32 versions are measured against."""
    def bf16(t):
        return t.float().bfloat16().double()

    H = h0.shape[-1]
    wb = bf16(w)
    x, alive, h = x.double(), alive.double(), h0.double()
    out = []
    for t in range(x.shape[0]):
        ur = bf16(h) @ wb[:, :2 * H]
        u = torch.sigmoid(x[t][:, :H] + ur[:, :H])
        r = torch.sigmoid(x[t][:, H:2 * H] + ur[:, H:])
        c = torch.tanh(x[t][:, 2 * H:] + bf16(r * h) @ wb[:, 2 * H:])
        h = alive[t] * (u * c + (1 - u) * h) + (1 - alive[t]) * h
        out.append(h)
    return torch.stack(out)


def ctc_feed(fluid, seed):
    """One batch of CTC_BATCH utterances of CTC_FRAMES frames of
    CTC_FEAT features (one at the longest), each with a label of
    ⌈frames/8⌉..⌊frames/4⌋ characters of CTC_CLASSES."""
    import numpy as np
    rng = np.random.RandomState(seed + 11)
    frames = rng.randint(CTC_FRAMES[0], CTC_FRAMES[1] + 1, CTC_BATCH)
    frames[0] = CTC_FRAMES[1]
    ulens = [rng.randint(-(-int(f) // 8), int(f) // 4 + 1) for f in frames]
    feats = [rng.normal(0, 1, (int(f), CTC_FEAT)).astype("float32")
             for f in frames]
    labels = [rng.randint(1, CTC_CLASSES + 1, (u, 1)).astype("int64")
              for u in ulens]
    return {"feat": fluid.pack_sequences(feats),
            "label": fluid.pack_sequences(labels)}


def phase_seq_kernels(torch, fluid, seed, card):
    """gru_seq, gru_seq_bwd, ctc_alpha and ctc_loss_bwd against their plain
    versions at the lane's and the CTC model's shapes, then their times.
    Returns {kernel: numbers for the kernels line}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import ctc
    from paddle_tpu_torch.ops.cuda import rnn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    L, b, H = SEQ_LEN, SEQ_BATCH, SEQ_HIDDEN
    lens = torch.randint(1, L + 1, (b,), generator=gen, device=dev)
    lens[: b // 4] = L
    x, alive, w, h0, dhs = gru_operands(torch, gen, dev, lens)
    log(f"\n== phase 7: gru_seq / gru_seq_bwd vs their plain versions, "
        f"b {b}, L {L}, H {H}, lengths {int(lens.min())}..{int(lens.max())} "
        f"({int((lens == L).sum())} full) ==")
    out = {}
    hs = rnn.gru_seq(x, alive, w, h0)
    torch.cuda.synchronize()
    ref = rnn.gru_seq_torch(x, alive, w, h0)
    inf, l2, d = rel_errs(hs, ref)
    exact = gru_float64(torch, x, alive, w, h0)
    k64 = (hs.double() - exact).abs().max().item()
    p64 = (ref.double() - exact).abs().max().item()
    log(f"  gru_seq hs: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit {GRU_FWD_LIMIT:.0e}), "
        f"‖Δ‖₂/‖ref‖₂ {l2:.3e} (limit {GRU_FWD_L2_LIMIT:.0e}); ‖Δ‖∞ to the "
        f"float64 recipe: kernel {k64:.3e}, plain {p64:.3e} (limit "
        f"{GRU_F64_RATIO}x the plain's)")
    if not (inf <= GRU_FWD_LIMIT and l2 <= GRU_FWD_L2_LIMIT
            and k64 <= GRU_F64_RATIO * p64):
        fail(f"gru_seq differs from gru_seq_torch: {inf:.3e} / {l2:.3e}; "
             f"to float64 {k64:.3e} vs {p64:.3e}")
    out["gru_seq"] = {"max_abs_err": d}
    # the backward from the plain carries, so that it is held alone
    got = rnn.gru_seq_bwd(x, alive, w, h0, ref, dhs)
    torch.cuda.synchronize()
    want = rnn.gru_seq_bwd_torch(x, alive, w, h0, ref, dhs)
    worst = 0.0
    for name, g, r in zip(("dx", "dw", "dh0"), got, want):
        inf, l2, d = rel_errs(g, r)
        worst = max(worst, d)
        log(f"  gru_seq_bwd {name}: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
            f"{GRU_BWD_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {l2:.3e} (limit "
            f"{GRU_BWD_L2_LIMIT:.0e})")
        if not (inf <= GRU_BWD_LIMIT and l2 <= GRU_BWD_L2_LIMIT):
            fail(f"gru_seq_bwd {name} differs from gru_seq_bwd_torch: "
                 f"{inf:.3e} / {l2:.3e}")
    out["gru_seq_bwd"] = {"max_abs_err": worst}

    fd = ctc_feed(fluid, seed)
    xl = fd["feat"].lens.to(dev)
    yl = fd["label"].lens.to(dev)
    labels = fd["label"].data[..., 0].to(dev)
    T, C = int(xl.max()), CTC_CLASSES + 1
    logits = torch.randn((CTC_BATCH, T, C), generator=gen, device=dev)
    dloss = torch.randn((CTC_BATCH,), generator=gen, device=dev)
    logp = torch.log_softmax(logits, -1)
    inputs = ctc.ctc_inputs(logp, labels, yl, xl, 0)
    sp = inputs[0].shape[-1]
    log(f"\n== phase 7: ctc_alpha / ctc_loss_bwd vs their plain versions, "
        f"b {CTC_BATCH}, T {T}, C {C}, Sp {sp}, frames "
        f"{int(xl.min())}..{T}, labels {int(yl.min())}..{int(yl.max())} ==")
    loss = ctc.ctc_alpha(*inputs, xl, yl)
    torch.cuda.synchronize()
    want = ctc.ctc_alpha_torch(*inputs, xl, yl)
    inf, l2, d = rel_errs(loss, want)
    lib = F.ctc_loss(logp.transpose(0, 1), labels, xl, yl, blank=0,
                     reduction="none")
    lib_rel = ((lib - want[:, 0]).abs() / want[:, 0].abs()).max().item()
    log(f"  ctc_alpha loss: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
        f"{CTC_FWD_LIMIT:.0e}); F.ctc_loss against the plain version: max "
        f"rel diff {lib_rel:.3e} (printed only: another summation)")
    if not inf <= CTC_FWD_LIMIT:
        fail(f"ctc_alpha differs from ctc_alpha_torch: {inf:.3e}")
    out["ctc_alpha"] = {"max_abs_err": d}
    got = ctc.ctc_loss_bwd(logp, xl, labels, yl, 0, dloss)
    torch.cuda.synchronize()
    want = ctc.ctc_loss_bwd_torch(logp, xl, labels, yl, 0, dloss)
    inf, l2, d = rel_errs(got, want)
    log(f"  ctc_loss_bwd dlogits: ‖Δ‖∞/‖ref‖∞ {inf:.3e} (limit "
        f"{CTC_BWD_LIMIT:.0e}), ‖Δ‖₂/‖ref‖₂ {l2:.3e}")
    if not inf <= CTC_BWD_LIMIT:
        fail(f"ctc_loss_bwd differs from ctc_loss_bwd_torch: {inf:.3e}")
    out["ctc_loss_bwd"] = {"max_abs_err": d}

    log(f"\n== phase 7: times at the lane's and the CTC model's shapes | "
        f"{card} ==")
    # operations of one gru_seq: the gate products (bf16 operands) and ~30
    # per cell; bytes: x, alive, w, h0 read, hs written
    gemm = 2 * L * b * H * 3 * H
    fwd_bytes = 4 * (L * b * 3 * H + L * b + 3 * H * H + b * H + L * b * H)
    t_ops = gemm / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = fwd_bytes / PEAK_BYTES * 1e3
    out["gru_seq"].update(
        ms=time_ms(lambda: rnn.gru_seq(x, alive, w, h0), torch),
        plain_ms=time_ms(lambda: rnn.gru_seq_torch(x, alive, w, h0), torch),
        library_ms=None, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    # the backward: the gate products again (bf16 operands), then the two
    # dh products and dW (float32 dgates against bf16 values); bytes: the
    # forward's inputs, its carries and their cotangents read, dx, dw and
    # dh0 written
    t_ops = (gemm / PEAK_FLOPS["bfloat16"]
             + 2 * gemm / PEAK_FLOPS["float32"]) * 1e3
    bwd_bytes = 4 * (2 * L * b * 3 * H + L * b + 2 * 3 * H * H + 2 * b * H
                     + 2 * L * b * H)
    t_bytes = bwd_bytes / PEAK_BYTES * 1e3
    out["gru_seq_bwd"].update(
        ms=time_ms(lambda: rnn.gru_seq_bwd(x, alive, w, h0, ref, dhs),
                   torch),
        plain_ms=time_ms(lambda: rnn.gru_seq_bwd_torch(
            x, alive, w, h0, ref, dhs), torch),
        library_ms=None, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    serial = time_ms(lambda: rnn.barrier_chain(H // 4, 2 * L, dev), torch)
    for k in ("gru_seq", "gru_seq_bwd"):
        t = out[k]
        log(f"{k} per launch: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library none (torch.nn.GRU applies r "
            f"after the recurrent product, cuDNN's formula: another "
            f"function), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"serial floor {serial:.4f} ms ({2 * L} grid barriers over "
            f"{H // 4} blocks)")

    # CTC work that this batch's lengths need, not the padded T: ~16
    # operations per label position and step of the recurrence (two
    # logaddexp and the emission's add). The forward reads e at the steps
    # t = 1..x_len-1 of each row (alpha0 stands for t = 0), alpha0 and the
    # two masks, final0 and the lengths, and writes the loss
    steps = int((xl - 1).clamp_min(0).sum())
    frames = int(xl.sum())
    t_ops = 16 * steps * sp / PEAK_FLOPS["float32"] * 1e3
    t_bytes = 4 * (steps * sp + CTC_BATCH * (3 * sp + 4)) / PEAK_BYTES * 1e3
    lg_leaf = logits.detach().requires_grad_(True)
    with torch.enable_grad():
        lib_loss = F.ctc_loss(torch.log_softmax(lg_leaf, -1).transpose(0, 1),
                              labels, xl, yl, blank=0, reduction="none")
    lib_ct = dloss.clone()
    out["ctc_alpha"].update(
        ms=time_ms(lambda: ctc.ctc_alpha(*inputs, xl, yl), torch),
        plain_ms=time_ms(lambda: ctc.ctc_alpha_torch(*inputs, xl, yl),
                         torch),
        library_ms=time_ms(lambda: F.ctc_loss(
            logp.transpose(0, 1), labels, xl, yl, blank=0,
            reduction="none"), torch),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    # the backward: the recurrence again, ~30 operations per position and
    # step of the scan's adjoint, and per frame one add per label position
    # (the emissions' cotangents onto their classes) and ~3 per class (the
    # log-softmax's backward). It reads logp at the rows' frames, the labels
    # (int64), the lengths and dloss, and writes all of dlogits [b, T, C]
    # (zeros past each row's frames)
    t_ops = ((16 + 30) * steps * sp + frames * (sp + 3 * C)) \
        / PEAK_FLOPS["float32"] * 1e3
    t_bytes = (4 * (frames * C + CTC_BATCH * T * C + 3 * CTC_BATCH)
               + 8 * labels.numel()) / PEAK_BYTES * 1e3
    out["ctc_loss_bwd"].update(
        ms=time_ms(lambda: ctc.ctc_loss_bwd(logp, xl, labels, yl, 0, dloss),
                   torch),
        plain_ms=time_ms(lambda: ctc.ctc_loss_bwd_torch(
            logp, xl, labels, yl, 0, dloss), torch),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_loss, lg_leaf, lib_ct, retain_graph=True), torch),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    for k, lib_name in (("ctc_alpha", "F.ctc_loss"),
                        ("ctc_loss_bwd", "F.ctc_loss backward, with the "
                         "log-softmax's")):
        t = out[k]
        log(f"{k} per launch: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, {lib_name} {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return out


def build_ctc_acoustic(fluid, seed):
    """tests/book/test_ocr_ctc.py:38-50 at phase 9's widths, with
    Adam(CTC_LR, fused=True). Returns (main, startup, loss, logits)."""
    from paddle_tpu_torch.testing.models import ctc_acoustic
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        feat = fluid.layers.data("feat", shape=[CTC_FEAT], lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64",
                                  lod_level=1)
        logits, loss = ctc_acoustic(feat, label, CTC_CLASSES, CTC_HIDDEN)
        fluid.optimizer.Adam(learning_rate=CTC_LR, fused=True).minimize(
            loss, startup)
    return main, startup, loss, logits


def phase_ctc(torch, fluid, seed, card):
    """Train the CTC acoustic model 5 steps on one batch under both routes
    and hold step 1 of the kernel route to the plain-version route; then
    greedy-decode the batch through ``main.clone(for_test=True)`` and print
    the normalized edit distance. Returns the launches of each kernel on
    the kernel route."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import ctc
    from paddle_tpu_torch.ops.cuda import optimizer as opk
    from paddle_tpu_torch.ops.cuda import rnn

    log(f"\n== phase 9: CTC acoustic model, batch {CTC_BATCH}, "
        f"{CTC_FRAMES[0]}..{CTC_FRAMES[1]} frames of {CTC_FEAT} features, "
        f"hidden {CTC_HIDDEN}, {CTC_CLASSES} + 1 classes, {SEQ_STEPS} steps "
        f"on one batch ==")
    main, startup, loss, logits = build_ctc_acoustic(fluid, seed)
    fd = ctc_feed(fluid, seed)
    gru_w, = [op.input("Weight")[0] for op in main.global_block().ops
              if op.type == "gru_grad"]
    totals, trained, exe = train_phase(torch, fluid, card, dict(
        title="CTC acoustic model", main=main, startup=startup, loss=loss,
        batch=CTC_BATCH, feeds=[("utterances", fd)],
        counters=[("gru_seq", lambda: rnn.launches["gru_seq"]),
                  ("gru_seq_bwd", lambda: rnn.launches["gru_seq_bwd"]),
                  ("ctc_alpha", lambda: ctc.launches["ctc_alpha"]),
                  ("ctc_loss_bwd", lambda: ctc.launches["ctc_loss_bwd"]),
                  ("adam_arena", lambda: opk.launches["adam_arena"]),
                  ("plain-routed GRUs",
                   lambda: tier.fallback_counts().get("gru", 0)),
                  ("plain-routed CTCs",
                   lambda: tier.fallback_counts().get("ctc", 0))],
        resets=[rnn.reset_launches, ctc.reset_launches, opk.reset_launches,
                tier.reset_fallback_counts],
        want=(1, 1, 1, 1, 1, 0, 0),
        swaps=[(rnn, "gru_seq", rnn.gru_seq_torch),
               (rnn, "gru_seq_bwd", rnn.gru_seq_bwd_torch),
               (ctc, "ctc_alpha", ctc.ctc_alpha_torch),
               (ctc, "ctc_loss_bwd", ctc.ctc_loss_bwd_torch)],
        # dlogits x PLANTED in the step's one ctc_loss_bwd launch: every
        # gradient below the loss moves by it
        plant=dict(module=ctc, attr="ctc_loss_bwd", index=None, at=0,
                   calls=1, param=gru_w, what="dlogits"),
        loss_limit=GRU_TRAIN_LOSS_LIMIT, grad_limit=GRU_TRAIN_GRAD_LIMIT))

    # decode the batch as tests/book/test_ocr_ctc.py decodes its test batch
    infer = main.clone(for_test=True)
    eval_prog, eval_start = fluid.Program(), fluid.Program()
    with fluid.program_guard(eval_prog, eval_start):
        lg = fluid.layers.data("lg", shape=[CTC_CLASSES + 1], lod_level=1)
        lb = fluid.layers.data("lb", shape=[1], dtype="int64", lod_level=1)
        decoded = fluid.layers.ctc_greedy_decoder(input=lg, blank=0)
        dist, _ = fluid.layers.edit_distance(input=decoded, label=lb,
                                             normalized=True)
    scope = copy_scope(fluid, torch, trained)
    lg_out, = exe.run(infer, feed=fd, fetch_list=[logits], scope=scope,
                      return_numpy=False)
    dec, d = exe.run(eval_prog, feed={"lg": lg_out, "lb": fd["label"]},
                     fetch_list=[decoded, dist], scope=scope)
    if d.shape != (CTC_BATCH, 1) or not np.isfinite(d).all():
        fail(f"edit_distance gave {d.shape}, finite={np.isfinite(d).all()}")
    log(f"greedy decoding after {SEQ_STEPS} steps: decoded lengths "
        f"{int(dec.lens.min())}..{int(dec.lens.max())} (labels "
        f"{int(fd['label'].lens.min())}..{int(fd['label'].lens.max())}); "
        f"mean normalized edit distance {float(d.mean()):.4f}")
    return totals


def zipf_ranks(rng, n, size):
    """``size`` ranks in [0, n) with rank-frequency 1/rank^ZIPF_S."""
    import numpy as np
    p = 1.0 / np.arange(1, n + 1) ** ZIPF_S
    return rng.choice(n, size=size, p=p / p.sum())


def zipf_ids(rng, n, size):
    """``size`` ids of ``n`` with rank-frequency 1/rank^ZIPF_S, the ranks
    mapped to ids by a seeded permutation."""
    ranks = zipf_ranks(rng, n, size)
    return rng.permutation(n)[ranks]


def ctr_ids(rng):
    """Phase 10's CTR batch: CTR_BATCH examples, each with one value per
    Criteo field drawn by rank from that field's vocabulary, hashed
    (splitmix64 of field and value) into CTR_ROWS rows; field-major, as
    the sum of the fields' gradients orders them."""
    import numpy as np
    salt = np.uint64(rng.randint(1 << 31))
    out = []
    for f, vocab in enumerate(CRITEO_VOCABS):
        z = (np.uint64(f) << np.uint64(32)) \
            | zipf_ranks(rng, vocab, CTR_BATCH).astype(np.uint64)
        z = z ^ salt
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
        out.append((z % np.uint64(CTR_ROWS)).astype(np.int64))
    return np.concatenate(out)


def build_word2vec(fluid, seed):
    """tests/book/test_word2vec.py at phase 11's widths, with
    SGD(W2V_LR, fused=True). Returns (main, startup, loss)."""
    from paddle_tpu_torch.testing.models import ngram_lm
    fluid.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(f"w{i}", shape=[1], dtype="int64")
                 for i in range(W2V_N - 1)]
        nextw = fluid.layers.data("nextw", shape=[1], dtype="int64")
        predict = ngram_lm(words, W2V_DICT, W2V_EMB, W2V_HIDDEN)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(predict, nextw))
        fluid.optimizer.SGD(learning_rate=W2V_LR, fused=True).minimize(
            loss, startup)
    return main, startup, loss


def word2vec_feed(seed):
    """One batch of W2V_BATCH N-grams of Zipf-skewed word ids."""
    import numpy as np
    grams = zipf_ids(np.random.RandomState(seed + 11), W2V_DICT,
                     (W2V_BATCH, W2V_N)).astype("int64")
    feed = {f"w{i}": grams[:, i:i + 1] for i in range(W2V_N - 1)}
    feed["nextw"] = grams[:, W2V_N - 1:]
    return feed


def phase_sparse_kernels(torch, fluid, seed, card):
    """embedding_sgd and sgd_arena against their plain versions, bitwise,
    then their times. Returns {kernel: numbers for the kernels line}, at
    word2vec's shapes (the main path's)."""
    import numpy as np
    from paddle_tpu_torch.ops.cuda import embedding as embk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    rng = np.random.RandomState(seed + 10)
    lr = torch.full((1,), W2V_LR, device=dev)
    out = {}
    log(f"\n== phase 10: embedding_sgd vs embedding_sgd_torch, bitwise, "
        f"then times | {card} ==")
    n_w2v = (W2V_N - 1) * W2V_BATCH
    w2v_rows = zipf_ids(rng, W2V_DICT, n_w2v)
    w2v_rows[rng.choice(n_w2v, W2V_SENTINELS, replace=False)] = W2V_DICT
    cases = [("word2vec", W2V_DICT, W2V_EMB, w2v_rows),
             ("CTR", CTR_ROWS, CTR_DIM, ctr_ids(rng))]
    for name, v, d, rows_np in cases:
        rows = torch.from_numpy(rows_np.astype("int64")).to(dev)
        real = rows_np[rows_np < v]
        uniq, counts = np.unique(real, return_counts=True)
        n, u = len(rows_np), len(uniq)
        w = torch.randn((v, d), generator=gen, device=dev) * 0.05
        vals = torch.randn((n, d), generator=gen, device=dev) * 1e-3
        want = embk.embedding_sgd_torch(w, rows, vals, lr)
        got = embk.embedding_sgd(w.clone(), rows, vals, lr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            diff = (got - want).abs().max().item()
            fail(f"embedding_sgd at {name}'s shape differs from "
                 f"embedding_sgd_torch: max abs {diff:.3e}, want bitwise")
        untouched = torch.ones(v, dtype=torch.bool, device=dev)
        untouched[torch.from_numpy(uniq).to(dev)] = False
        if not torch.equal(got[untouched], w[untouched]):
            fail(f"embedding_sgd at {name}'s shape changed rows no entry "
                 "names")
        same = embk.embedding_sgd(w.clone(), torch.full_like(rows, v),
                                  vals, lr)
        torch.cuda.synchronize()
        if not torch.equal(same, w):
            fail(f"embedding_sgd at {name}'s shape: an all-sentinel call "
                 "changed the table")
        log(f"{name}: table [{v}, {d}], {n} entries ({n - len(real)} "
            f"sentinels), {u} unique rows, longest run {counts.max()}: "
            "bitwise equal; all-sentinel call the identity; untouched rows "
            "unchanged")
        lib_w = w.clone()
        lib_rows = torch.from_numpy(real.astype("int64")).to(dev)
        lib_vals = vals[torch.from_numpy(
            np.flatnonzero(rows_np < v)).to(dev)].contiguous()
        t = dict(max_abs_err=0.0,
                 ms=time_ms(lambda: embk.embedding_sgd(got, rows, vals, lr),
                            torch),
                 plain_ms=time_ms(lambda: embk.embedding_sgd_torch(
                     w, rows, vals, lr), torch),
                 library_ms=time_ms(lambda: lib_w.index_add_(
                     0, lib_rows, lib_vals, alpha=-W2V_LR), torch))
        # bytes: each unique row read and written, each entry's values and
        # row index read
        t["bound_ms"], t["bound_by"] = bound_ms(0, 8 * u * d + 4 * n * d
                                                + 8 * n)
        log(f"embedding_sgd at {name}'s shape per call: kernel "
            f"{t['ms']:.4f} ms (its sort included), plain "
            f"{t['plain_ms']:.4f} ms, w.index_add_ on the unmerged entries "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")
        if name == "word2vec":
            out["embedding_sgd"] = t
        del w, got, want, same, lib_w

    main, _, _ = build_word2vec(fluid, seed)
    rmain, _, _ = build_resnet50_train(fluid, seed)
    for name, prog in (("word2vec", main), ("ResNet-50", rmain)):
        params = [p for p in prog.global_block().all_parameters()
                  if p.trainable and p.name != "shared_w"]
        nelem = sum(_numel(p.shape) for p in params)
        ps = [torch.randn(p.shape, generator=gen, device=dev) * 0.05
              for p in params]
        gs = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3
              for p in params]
        want = opk.sgd_arena_torch(ps, gs, lr)
        got = opk.sgd_arena([p.clone() for p in ps], gs, lr)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            diff = max((a - b).abs().max().item() for a, b in zip(got, want))
            fail(f"sgd_arena over {name}'s parameters differs from "
                 f"sgd_arena_torch: max abs {diff:.3e}, want bitwise")
        lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
        for p, g in zip(lib_ps, gs):
            p.grad = g
        sgd = torch.optim.SGD(lib_ps, lr=W2V_LR, fused=True)
        t = dict(max_abs_err=0.0,
                 ms=time_ms(lambda: opk.sgd_arena(got, gs, lr), torch),
                 plain_ms=time_ms(lambda: opk.sgd_arena_torch(ps, gs, lr),
                                  torch),
                 library_ms=time_ms(sgd.step, torch))
        t["bound_ms"], t["bound_by"] = bound_ms(0, 12 * nelem)
        log(f"sgd_arena over {name}'s {len(ps)} dense tensors ({nelem} "
            f"elements): bitwise equal; per step kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, SGD(fused=True) "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")
        if name == "word2vec":
            out["sgd_arena"] = t
    return out


def phase_word2vec(torch, fluid, seed, card):
    """Train the word2vec N-gram model 5 steps on one batch under both
    routes; hold step 1 of the kernel route to the same program with the
    plain-version wrappers (bitwise) and to the plain route (float32
    roundings of the unmerged scatter); returns the launches of each
    kernel on the kernel route."""
    import numpy as np
    from paddle_tpu_torch.ops import cuda as tier
    from paddle_tpu_torch.ops.cuda import embedding as embk
    from paddle_tpu_torch.ops.cuda import optimizer as opk

    log(f"\n== phase 11: word2vec N-gram model, dict {W2V_DICT}, "
        f"{W2V_N - 1} context words, embedding {W2V_EMB}, hidden "
        f"{W2V_HIDDEN}, batch {W2V_BATCH}, SGD({W2V_LR}, fused=True), "
        f"{W2V_STEPS} steps on one batch ==")
    main, startup, loss = build_word2vec(fluid, seed)
    block = main.global_block()
    log("program: " + op_counts(block))
    update, = [op for op in block.ops if op.type == "fused_sgd"]
    params = update.input("Params")
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    feed = word2vec_feed(seed)
    ids = np.concatenate([feed[f"w{i}"].ravel() for i in range(W2V_N - 1)])
    uniq, counts = np.unique(ids, return_counts=True)
    log(f"batch: {len(ids)} context ids, {len(uniq)} distinct, the most "
        f"frequent {counts.max()} times")

    def run(route, scope):
        fluid.set_flags({"kernel_tier": route})
        try:
            out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)
        finally:
            fluid.set_flags({"kernel_tier": "auto"})
        return out[0]

    def state(scope):
        return {n: scope.find_var(n).clone() for n in params}

    counters = (("embedding_sgd", lambda: embk.launches["embedding_sgd"]),
                ("sgd_arena", lambda: opk.launches["sgd_arena"]),
                ("plain-routed tables",
                 lambda: tier.fallback_counts().get("embedding_sgd", 0)),
                ("plain-routed arenas",
                 lambda: tier.fallback_counts().get("optimizer", 0)))
    labels = [c[0] for c in counters]
    want = {"auto": (1, 1, 0, 0), "torch": (0, 0, 0, 0)}
    res = {}
    for route in ("auto", "torch"):
        scope = copy_scope(fluid, torch, init)
        losses, ms, total = [], [], [0] * len(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(W2V_STEPS):
            embk.reset_launches()
            opk.reset_launches()
            tier.reset_fallback_counts()
            t0 = time.perf_counter()
            lv = run(route, scope)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got = tuple(get() for _, get in counters)
            if got != want[route]:
                fail(f"word2vec, kernel_tier={route} step {step + 1}: "
                     f"{'/'.join(labels)} {got}, want {want[route]}")
            total = [a + c for a, c in zip(total, got)]
            if lv.shape != () or not torch.isfinite(lv).item():
                fail(f"word2vec, kernel_tier={route} step {step + 1}: loss "
                     f"{lv}")
            losses.append(lv.item())
            if step == 0:
                first = state(scope)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = sum(ms[1:]) / len(ms[1:])
        res[route] = dict(losses=losses, step1=first, total=total,
                          scope=scope)
        log(f"kernel_tier={route}: losses "
            + " ".join(f"{v:.7f}" for v in losses)
            + " | ms/step " + " ".join(f"{v:.2f}" for v in ms)
            + f" | steady {steady:.3f} ms/step, "
            f"{W2V_BATCH * 1e3 / steady:.1f} sequences/s | peak memory "
            f"{peak:.3f} GiB | {card}")

    # the reference: the same program with both wrappers swapped for their
    # plain versions
    swaps = ((embk, "embedding_sgd", embk.embedding_sgd_torch),
             (opk, "sgd_arena", opk.sgd_arena_torch))
    real = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    for m, a, plain in swaps:
        setattr(m, a, plain)
    try:
        ref_scope = copy_scope(fluid, torch, init)
        ref_loss = run("auto", ref_scope).item()
        ref = state(ref_scope)
    finally:
        for m, a, fn in real:
            setattr(m, a, fn)

    problems = []
    kernel = res["auto"]
    w0 = init.find_var("shared_w")
    # one float32 step at the table's largest magnitude: every rounding of
    # the two routes' updates happens at or below it
    ulp = (torch.nextafter(w0.abs().max(), torch.tensor(float("inf"),
                                                        device=w0.device))
           - w0.abs().max()).item()
    diffs = {n: (kernel["step1"][n] - ref[n]).abs().max().item()
             for n in params}
    log(f"step 1, kernel route vs plain-version wrappers: loss "
        f"{kernel['losses'][0]!r} vs {ref_loss!r}; max |Δ| per parameter "
        "(limit 0, bitwise): "
        + ", ".join(f"{n} {v:.3e}" for n, v in diffs.items()))
    if kernel["losses"][0] != ref_loss or any(diffs.values()):
        problems.append("word2vec step 1 is not bitwise the plain-version "
                        "wrappers' step")
    # the plain route adds each entry's −lr·v to its row one at a time (a
    # rounding at the row's magnitude per entry) where the kernel subtracts
    # lr times their sum once: up to (longest run + 1) float32 steps apart;
    # the dense parameters take the same expression on both routes
    limit = (counts.max() + 1) * ulp
    plain = res["torch"]["step1"]
    dw = (kernel["step1"]["shared_w"] - plain["shared_w"]).abs().max().item()
    dense = max((kernel["step1"][n] - plain[n]).abs().max().item()
                for n in params if n != "shared_w")
    log(f"step 1, kernel route vs kernel_tier=torch (unmerged scatter): "
        f"shared_w max |Δ| {dw:.3e} = {dw / ulp:.1f} float32 steps of "
        f"max|w| (limit {counts.max() + 1}); dense parameters max |Δ| "
        f"{dense:.3e} (limit 0)")
    if not dw <= limit or dense != 0:
        problems.append("word2vec step 1 on the kernel route is beyond the "
                        "limits against the plain route")
    fed = torch.zeros(W2V_DICT, dtype=torch.bool, device=w0.device)
    fed[torch.from_numpy(uniq).to(w0.device)] = True
    trained = kernel["scope"].find_var("shared_w")
    if not torch.equal(trained[~fed], w0[~fed]):
        problems.append("word2vec: table rows absent from the batch moved")
    moved = (trained[fed] - w0[fed]).abs().max().item()
    log(f"after {W2V_STEPS} steps: the {int((~fed).sum())} table rows "
        f"absent from the batch unchanged: "
        f"{torch.equal(trained[~fed], w0[~fed])}; max |Δ| of the "
        f"{len(uniq)} fed rows {moved:.3e}")

    # the check's own test: lr x PLANTED in the step's embedding_sgd launch
    good, calls = embk.embedding_sgd, [0]

    def planted(w, rows, vals, lr):
        calls[0] += 1
        return good(w, rows, vals, lr * PLANTED if calls[0] == 1 else lr)

    embk.embedding_sgd = planted
    try:
        bad_scope = copy_scope(fluid, torch, init)
        run("auto", bad_scope)
        bad = (bad_scope.find_var("shared_w") - ref["shared_w"]).abs().max() \
            .item()
    finally:
        embk.embedding_sgd = good
    log(f"planted fault: lr x{PLANTED} in the step's embedding_sgd launch: "
        f"shared_w max |Δ| {bad:.3e} = {bad / ulp:.1f} float32 steps "
        "(limit 0)")
    if calls[0] != 1 or not bad > 0:
        problems.append("word2vec: the bitwise check does not see a planted "
                        f"lr x{PLANTED} in embedding_sgd ({calls[0]} calls)")
    for route in ("auto", "torch"):
        losses = res[route]["losses"]
        if not losses[-1] < losses[0]:
            problems.append(f"word2vec, kernel_tier={route}: loss did not "
                            f"fall over {W2V_STEPS} steps: {losses}")
    if problems:
        fail("; ".join(problems))
    for route, title in (("auto", "kernel route"), ("torch", "plain route")):
        scope = copy_scope(fluid, torch, init)
        profile(torch, lambda: run(route, scope),
                f"word2vec: one training step, batch {W2V_BATCH}, {title}",
                card, reps=5)
    return dict(zip(labels, kernel["total"]))


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
    for name, (secs, out) in build.build(KERNELS).items():
        log(f"built {name} in {secs:.2f} s")
        for line in out.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"  {line.strip()}")

    totals = phase_kernels(torch, fluid, args.seed)
    train_totals = phase_train_kernels(torch, fluid, args.seed)
    launches = phase_serving(torch, fluid, args.seed, card)
    train_launches = phase_training(torch, fluid, args.seed, card)
    rnn_totals = phase_rnn_kernels(torch, fluid, args.seed, card)
    rnn_launches = phase_textcls(torch, fluid, args.seed, card)
    seq_totals = phase_seq_kernels(torch, fluid, args.seed, card)
    gru_launches = phase_textcls(torch, fluid, args.seed, card, "gru")
    ctc_launches = phase_ctc(torch, fluid, args.seed, card)
    sparse_totals = phase_sparse_kernels(torch, fluid, args.seed, card)
    w2v_launches = phase_word2vec(torch, fluid, args.seed, card)

    def entry(name, source, replaces, n, t):
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{source}",
                "replaces": f"paddle_tpu/ops/{replaces}",
                "launches": n, "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    kernels = [
        entry("conv_affine", "conv_affine.cu", "pallas/conv_bn.py:261",
              launches, totals),
        entry("conv_bn_train", "conv_bn_train.cu", "pallas/conv_bn.py:191",
              train_launches["conv_bn_train"], train_totals["conv_bn_train"]),
        entry("conv_bn_bwd", "conv_bn_bwd.cu", "pallas/conv_bn.py:379",
              train_launches["conv_bn_bwd"], train_totals["conv_bn_bwd"]),
        entry("momentum_arena", "optimizer_arena.cu",
              "pallas/optimizer.py:111", train_launches["momentum_arena"],
              train_totals["momentum_arena"]),
        entry("lstm_seq", "lstm_seq.cu", "pallas/rnn.py:124",
              rnn_launches["lstm_seq"], rnn_totals["lstm_seq"]),
        entry("lstm_seq_bwd", "lstm_seq.cu", "pallas/rnn.py:133",
              rnn_launches["lstm_seq_bwd"], rnn_totals["lstm_seq_bwd"]),
        entry("adam_arena", "optimizer_arena.cu", "pallas/optimizer.py:129",
              rnn_launches["adam_arena"] + gru_launches["adam_arena"]
              + ctc_launches["adam_arena"], rnn_totals["adam_arena"]),
        entry("gru_seq", "gru_seq.cu", "pallas/rnn.py:233",
              gru_launches["gru_seq"] + ctc_launches["gru_seq"],
              seq_totals["gru_seq"]),
        entry("gru_seq_bwd", "gru_seq.cu", "pallas/rnn.py:242",
              gru_launches["gru_seq_bwd"] + ctc_launches["gru_seq_bwd"],
              seq_totals["gru_seq_bwd"]),
        entry("ctc_alpha", "ctc.cu", "pallas/ctc.py:66",
              ctc_launches["ctc_alpha"], seq_totals["ctc_alpha"]),
        entry("ctc_loss_bwd", "ctc.cu", "ctc_ops.py:155",
              ctc_launches["ctc_loss_bwd"], seq_totals["ctc_loss_bwd"]),
        entry("sgd_arena", "optimizer_arena.cu", "pallas/optimizer.py:92",
              w2v_launches["sgd_arena"], sparse_totals["sgd_arena"]),
        entry("embedding_sgd", "embedding_sgd.cu", "pallas/embedding.py:40",
              w2v_launches["embedding_sgd"], sparse_totals["embedding_sgd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
