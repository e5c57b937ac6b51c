"""The port's GRU text classifier and CTC acoustic model as a whole
against the reference.

bench.py:320's GRU text classifier, narrowed (vocab 50, emb 8, hidden 16,
2 GRU layers, 2 classes), and tests/book/test_ocr_ctc.py's CTC model
(fc(3H) -> dynamic_gru(H) -> fc(C+1) -> warpctc -> mean, at its widths but
for H 32 where it has 24: the GRU kernel takes H a multiple of 16; 12
features, 5 classes) are built by each package's front end with
Adam(fused=True). The programs must have the same ops and variables; the
port takes the reference's startup state by name, and on one ragged batch
the step-1 loss and every gradient, and the losses and final state of 3
steps, must agree in two pairings: the port's ``torch`` route against the
reference's ``jnp`` route (float32 scans), and its ``cuda`` route (every
kernel wrapper's plain version, on the CPU) against the reference's
``pallas`` route (the Pallas kernels in interpret mode). Then the CTC
model trains to convergence and greedy-decodes, as the book test does.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.lod import pack_sequences as jpack
from paddle_tpu_torch.core.lod import pack_sequences as tpack
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import ctc as tctc
from paddle_tpu_torch.ops.cuda import optimizer as topk
from paddle_tpu_torch.ops.cuda import rnn as trnn
from paddle_tpu_torch.testing.models import ctc_acoustic, gru_textcls

VOCAB, EMB, HIDDEN = 50, 8, 16
WORD_LENS = (9, 4, 1, 6)
FEAT, CTC_HIDDEN, CLASSES = 12, 32, 5
FRAME_LENS, LABEL_LENS = (12, 9, 15, 7), (4, 3, 5, 0)
STEPS = 3
# losses: float32 through the recurrences and back, sums in other orders
# and sigmoid/tanh/exp/log1p a float32 step apart between XLA and
# PyTorch; measured within 3e-7 relative, held to 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=0)
# step-1 gradients and the state after 3 steps, max|Δ| / max|ref| per
# variable. torch vs jnp: float32 roundings only (measured ≤ 5.4e-6). cuda
# vs pallas: each step's recurrent dW_t and the backward's two recurrent
# products are rounded to bfloat16 in both, and a float32 step of
# difference upstream can carry an element across a rounding boundary,
# which moves it by 2^-8 (3.9e-3) of itself and, through dh, the steps
# before it; Adam's moments take it on (measured ≤ 6.4e-4 on the CTC
# model's GRU weight gradient and moments). The parameters themselves are
# held by ‖Δ‖₂/‖ref‖₂: Adam steps each element by m/√v, so where a
# gradient lies within those rounding moves of 0 its step may take either
# sign, a move of up to 2·lr in one element (the CTC model's GRU weight:
# 4.8e-2 of its largest element, 1.7e-3 in norm, after 3 steps at 0.01)
REL = {"torch": 1e-5, "cuda": 1e-2}


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _build_textcls(fluid):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        prob = gru_textcls(words, vocab=VOCAB, emb=EMB, hidden=HIDDEN,
                           layers=fluid.layers)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam(learning_rate=2e-3, fused=True).minimize(
            loss, startup)
    return main, startup, loss


def _build_ctc(fluid, lr=0.01):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.program_guard(main, startup):
        feat = fluid.layers.data("feat", shape=[FEAT], lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64",
                                  lod_level=1)
        logits, loss = ctc_acoustic(feat, label, CLASSES, CTC_HIDDEN,
                                    layers=fluid.layers)
        fluid.optimizer.Adam(learning_rate=lr, fused=True).minimize(
            loss, startup)
    return main, startup, loss, logits


def _textcls_feed(pack):
    rng = np.random.RandomState(5)
    seqs = [rng.randint(0, VOCAB, (n, 1)).astype("int64") for n in WORD_LENS]
    return {"words": pack(seqs),
            "label": rng.randint(0, 2, (len(WORD_LENS), 1)).astype("int64")}


def _ctc_feed(pack):
    rng = np.random.RandomState(6)
    feats = [rng.normal(0, 1, (n, FEAT)).astype("float32")
             for n in FRAME_LENS]
    labels = [rng.randint(1, CLASSES + 1, (max(n, 1), 1)).astype("int64")
              [:n] for n in LABEL_LENS]
    return {"feat": pack(feats), "label": pack(labels)}


MODELS = {"gru_textcls": (_build_textcls, _textcls_feed),
          "ctc_acoustic": (_build_ctc, _ctc_feed)}


def _grad_names(main):
    update, = [op for op in main.global_block().ops
               if op.type == "fused_adam"]
    return update.input("Grads")


def _run(fluid, main, startup, loss, feed, scope, exe):
    grads = _grad_names(main)
    first = exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=scope)
    losses = [float(np.asarray(first[0]))] + [
        float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]))
        for _ in range(STEPS - 1)]
    return losses, dict(zip(grads, (np.asarray(g) for g in first[1:])))


def _reference(model, route):
    """The reference's startup state, its step-1 gradients, its losses and
    its final state."""
    build, feed = MODELS[model]
    jfluid.set_flags({"kernel_tier": route})
    main, startup, loss = build(jfluid)[:3]
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    state = [v.name for v in main.global_block().vars.values()
             if v.persistable and not v.is_data]
    init = {n: np.array(scope.find_var(n)) for n in state}
    losses, grads = _run(jfluid, main, startup, loss, feed(jpack), scope,
                         exe)
    final = {n: np.array(scope.find_var(n)) for n in state}
    return init, losses, grads, final


@pytest.mark.parametrize("model", sorted(MODELS))
def test_programs_have_the_same_ops_and_vars(model):
    build = MODELS[model][0]
    jmain = build(jfluid)[0]
    tmain = build(tfluid)[0]
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert sorted(tmain.global_block().vars) == \
        sorted(jmain.global_block().vars)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("routes", [("torch", "jnp"), ("cuda", "pallas")])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_training_steps_match_reference(model, routes, monkeypatch):
    init, want_losses, want_grads, want_final = _reference(model, routes[1])
    tfluid.set_flags({"kernel_tier": routes[0]})
    calls = {}

    def counted(module, name):
        real = getattr(module, name)
        calls[name] = 0

        def fn(*args):
            calls[name] += 1
            return real(*args)
        monkeypatch.setattr(module, name, fn)

    for module, name in ((trnn, "gru_seq"), (trnn, "gru_seq_bwd"),
                         (tctc, "ctc_alpha"), (tctc, "ctc_loss_bwd"),
                         (topk, "adam_arena")):
        counted(module, name)
    build, feed = MODELS[model]
    main, startup, loss = build(tfluid)[:3]
    scope = tfluid.io.scope_from_numpy(init, "cpu")
    ttier.reset_fallback_counts()
    losses, grads = _run(tfluid, main, startup, loss, feed(tpack), scope,
                         tfluid.Executor(tfluid.CPUPlace()))
    assert ttier.fallback_counts() == {}
    # the kernel route's wrappers per step: one GRU forward and backward
    # per layer (the grad op replays the forward's carries), the CTC
    # forward and backward, one arena update
    per_step = {("gru_textcls", "cuda"): (2, 2, 0, 0, 1),
                ("ctc_acoustic", "cuda"): (1, 1, 1, 1, 1)}.get(
        (model, routes[0]), (0, 0, 0, 0, 0))
    assert tuple(calls.values()) == tuple(STEPS * n for n in per_step)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    assert losses[-1] < losses[0]
    assert sorted(grads) == sorted(want_grads)
    for name, want in want_grads.items():
        assert grads[name].shape == want.shape, name
        assert _rel(grads[name], want) <= REL[routes[0]], name
    params = {n[:-len("@GRAD")] for n in want_grads}
    for name, want in want_final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        rel = (np.linalg.norm(got - want) / np.linalg.norm(want)
               if name in params else _rel(got, want))
        assert rel <= REL[routes[0]], name


def _synth_sample(rng, min_len=3, max_len=6):
    """tests/book/test_ocr_ctc.py's samples: each label emits 2-3 frames of
    a class-distinct pattern plus noise."""
    n = int(rng.randint(min_len, max_len + 1))
    labels = rng.randint(1, CLASSES + 1, n)
    frames = []
    for lab in labels:
        pattern = np.zeros(FEAT, "float32")
        pattern[2 * (lab - 1):2 * (lab - 1) + 2] = 1.0
        for _ in range(int(rng.randint(2, 4))):
            frames.append(pattern + 0.1 * rng.randn(FEAT))
    return (np.asarray(frames, "float32"),
            labels.reshape(-1, 1).astype("int64"))


def test_ctc_model_converges_and_decodes():
    """The port's counterpart of tests/book/test_ocr_ctc.py on the kernel
    route (the wrappers' plain versions on the CPU): train until the loss
    halves, then greedy-decode the logits of ``main.clone(for_test=True)``
    and score them with edit_distance."""
    tfluid.set_flags({"kernel_tier": "cuda"})
    main, startup, loss, logits = _build_ctc(tfluid)
    infer = main.clone(for_test=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    samples = [_synth_sample(rng) for _ in range(48)]

    def feed(batch):
        return {"feat": tpack([s[0] for s in batch]),
                "label": tpack([s[1] for s in batch])}

    first = last = None
    for _ in range(60):
        rng.shuffle(samples)
        for i in range(0, len(samples), 16):
            v, = exe.run(main, feed=feed(samples[i:i + 16]),
                         fetch_list=[loss], scope=scope)
            last = float(v)
            first = last if first is None else first
        if last < 0.15:
            break
    assert last < 0.5 * first, (first, last)

    eval_prog, eval_start = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(eval_prog, eval_start):
        lg = tfluid.layers.data("lg", shape=[CLASSES + 1], lod_level=1)
        lb = tfluid.layers.data("lb", shape=[1], dtype="int64", lod_level=1)
        decoded = tfluid.layers.ctc_greedy_decoder(input=lg, blank=0)
        dist, _ = tfluid.layers.edit_distance(input=decoded, label=lb,
                                              normalized=True)
    test_feed = feed(samples[:16])
    lg_out, = exe.run(infer, feed=test_feed, fetch_list=[logits],
                      scope=scope, return_numpy=False)
    d, = exe.run(eval_prog, feed={"lg": lg_out, "lb": test_feed["label"]},
                 fetch_list=[dist], scope=scope)
    assert d.shape == (16, 1)
    assert float(np.mean(d)) < 0.2, float(np.mean(d))
