"""Training the decoder LM in the port, against the reference.

The two grads the LM's backward needs, each held against the reference's
op on the same numpy inputs (``op_both``): ``layer_norm_grad`` with and
without Scale and Bias at begin_norm_axis 1 and 2, and
``causal_self_attention_grad`` at windows of 1, 5 and 16 positions, whose
masked scores (-1e9 in both packages) give exactly zero gradient. Then the
LM of ``build_tiny_lm`` (2 layers, emb 32, 2 heads, vocab 32) with
next-token labels, ``reshape`` to [b·T, vocab], softmax_with_cross_entropy
and mean, and ``Adam(fused=True)``, trained 3 steps on a 4 x 16 batch of
a noisy periodic corpus in both packages from the reference's startup
state: the losses agree within LOSS_RTOL and the step-1 gradients within
GRAD_ATOL_REL of their largest. The trained parameters, saved with
``save_inference_model`` from the test clone, serve through both
packages' ``GenerationEngine`` with equal greedy tokens.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.testing import models as jmodels
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.serving import ContinuousBatcher, GenerationEngine
from paddle_tpu_torch.testing import models as tmodels

from torch_cross import op_both, port_scope, ref_state

VOCAB, EMB, HEADS, LAYERS, MAX_POS = 32, 32, 2, 2, 64
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
# float32 sums in another order through 2 layers and a softmax, then
# Adam: the 3 losses measured within 1.3e-7 relative, the step-1
# gradients within 4.7e-7 of the largest
LOSS_RTOL = 1e-5
GRAD_ATOL_REL = 1e-5
ENGINE = dict(max_seqs=4, block_size=4, num_blocks=64, max_len=40,
              prefill_buckets=(8, 16))


def _rng_floats(seed, *shape):
    return np.random.RandomState(seed).normal(0, 1, shape) \
        .astype("float32")


# ---------------------------------------------------------------------------
# the two grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [(), ("Scale",), ("Bias",),
                                   ("Scale", "Bias")])
@pytest.mark.parametrize("axis", [1, 2])
def test_layer_norm_grad_matches_reference(slots, axis):
    shape = (3, 4, 6)
    norm = int(np.prod(shape[axis:]))
    feeds = {"x": _rng_floats(0, *shape), "dy": _rng_floats(1, *shape)}
    inputs = {"X": ["x"], "Y@GRAD": ["dy"]}
    outputs = {"X@GRAD": ["dx"]}
    for i, slot in enumerate(slots):
        feeds[slot.lower()] = _rng_floats(2 + i, norm)
        inputs[slot] = [slot.lower()]
        outputs[slot + "@GRAD"] = ["d" + slot.lower()]
    got = op_both("layer_norm_grad", inputs, outputs,
                  {"begin_norm_axis": axis, "epsilon": 1e-5}, feeds)
    assert len(got) == 1 + len(slots)


def test_layer_norm_grad_maker_keeps_the_optional_slots():
    """The backward of a layer_norm without Scale and Bias names neither
    slot; with both it names both and their grads."""
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[4, 6])
            x.stop_gradient = False
            bare = fluid.layers.layer_norm(x, scale=False, shift=False,
                                           begin_norm_axis=2)
            full = fluid.layers.layer_norm(x, begin_norm_axis=2)
            loss = fluid.layers.mean(
                fluid.layers.elementwise_add(bare, full))
            fluid.backward.append_backward(loss)
        grads = [op for op in main.global_block().ops
                 if op.type == "layer_norm_grad"]
        assert len(grads) == 2, fluid
        slots = sorted((sorted(op.inputs), sorted(op.outputs))
                       for op in grads)
        assert slots == [
            (["Bias", "Scale", "X", "Y@GRAD"],
             ["Bias@GRAD", "Scale@GRAD", "X@GRAD"]),
            (["X", "Y@GRAD"], ["X@GRAD"])], (fluid, slots)


def _attention_feeds(t, seed, dout=None):
    e = 8
    feeds = {n: _rng_floats(seed + i, 2, t, e)
             for i, n in enumerate(("q", "k", "v"))}
    feeds["dout"] = _rng_floats(seed + 3, 2, t, e) if dout is None else dout
    return feeds


_ATT = ({"Q": ["q"], "K": ["k"], "V": ["v"], "Out@GRAD": ["dout"]},
        {"Q@GRAD": ["dq"], "K@GRAD": ["dk"], "V@GRAD": ["dv"]},
        {"num_heads": 2})


@pytest.mark.parametrize("t", [1, 5, 16])
def test_causal_self_attention_grad_matches_reference(t):
    dq, dk, dv = op_both("causal_self_attention_grad", *_ATT,
                         _attention_feeds(t, 10 * t))
    assert dq.shape == dk.shape == dv.shape == (2, t, 8)
    if t == 1:
        # one position: the softmax weight is 1 whatever the score, so Q
        # and K get exactly zero gradient and V gets dOut
        assert not dq.any() and not dk.any()


@pytest.mark.parametrize("t", [5, 16])
def test_causal_self_attention_grad_is_zero_past_the_mask(t):
    """dOut only at query 0, which sees key 0 alone: every later key and
    value gets exactly 0 (its score is masked to -1e9, its softmax weight
    exactly 0.0), and so does query 0 (one visible key), in both
    packages."""
    dout = np.zeros((2, t, 8), np.float32)
    dout[:, 0] = _rng_floats(7, 2, 8)
    dq, dk, dv = op_both("causal_self_attention_grad", *_ATT,
                         _attention_feeds(t, 3, dout))
    assert not dk.any() and not dq.any()
    assert not dv[:, 1:].any() and dv[:, 0].any()


# ---------------------------------------------------------------------------
# the LM trained in both packages, then served
# ---------------------------------------------------------------------------

def lm_corpus(batch, seq, vocab, seed, noise=0.1):
    """Noisy periodic sequences: each row steps through the vocabulary by
    a stride of its own from a random start, and a ``noise`` share of the
    tokens is replaced by random ones. Returns (tokens, positions, labels)
    [batch, seq, 1] int64, the labels being the next tokens."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, vocab, (batch, 1))
    stride = rng.randint(1, 4, (batch, 1))
    seqs = (start + stride * np.arange(seq + 1)[None]) % vocab
    flip = rng.rand(batch, seq + 1) < noise
    seqs = np.where(flip, rng.randint(0, vocab, seqs.shape), seqs)
    seqs = seqs.astype(np.int64)[..., None]
    pos = np.broadcast_to(np.arange(seq, dtype=np.int64)[None, :, None],
                          (batch, seq, 1)).copy()
    return seqs[:, :-1].copy(), pos, seqs[:, 1:].copy()


def _build_lm(fluid, models):
    fluid.framework.reset_unique_name()
    main, startup, logits = models.build_tiny_lm(
        vocab=VOCAB, emb=EMB, heads=HEADS, n_layers=LAYERS, max_pos=MAX_POS)
    with fluid.program_guard(main, startup):
        labels = fluid.layers.data("labels", shape=[-1, 1], dtype="int64")
        flat = fluid.layers.reshape(logits, [-1, VOCAB])
        ce = fluid.layers.softmax_with_cross_entropy(
            flat, fluid.layers.reshape(labels, [-1, 1]))
        loss = fluid.layers.mean(ce)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(LR, fused=True).minimize(loss, startup)
    return main, startup, test, logits, loss


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' LM trained STEPS steps on one batch from the
    reference's startup state, their test clones saved as bundles."""
    tokens, pos, labels = lm_corpus(BATCH, SEQ, VOCAB, seed=0)
    feed = {"tokens": tokens, "positions": pos, "labels": labels}
    jmain, jstartup, jtest, jlogits, jloss = _build_lm(jfluid, jmodels)
    tmain, _, ttest, tlogits, tloss = _build_lm(tfluid, tmodels)
    jexe, jscope, state = ref_state(jmain, jstartup)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), port_scope(state)
    params = sorted(p.name for p in jmain.global_block().all_parameters())
    grads = [p + "@GRAD" for p in params]
    out = {"ref": [], "port": [], "params": params}
    for key, exe, main, scope, loss in (
            ("ref", jexe, jmain, jscope, jloss),
            ("port", texe, tmain, tscope, tloss)):
        for step in range(STEPS):
            fetch = [loss] + (grads if step == 0 else [])
            vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            out[key].append([np.asarray(v) for v in vals])
    root = tmp_path_factory.mktemp("torch_lm_train")
    out["ref_dir"], out["port_dir"] = str(root / "ref"), str(root / "port")
    jfluid.io.save_inference_model(out["ref_dir"], ["tokens", "positions"],
                                   [jlogits], jexe, jtest, scope=jscope)
    tfluid.io.save_inference_model(out["port_dir"], ["tokens", "positions"],
                                   [tlogits], texe, ttest, scope=tscope)
    return out


def test_lm_losses_match_reference_and_fall(trained):
    got = [float(s[0]) for s in trained["port"]]
    want = [float(s[0]) for s in trained["ref"]]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0], got


def test_lm_step1_gradients_match_reference(trained):
    """Every parameter's step-1 gradient within GRAD_ATOL_REL of the
    largest gradient element. The scale is the largest over all of them:
    the K projection's bias has a zero gradient in exact arithmetic (a
    shift of every key adds one constant to a query's scores, which the
    softmax ignores), so both packages give rounding noise of 1e-10
    there, which no per-tensor scale could compare."""
    got, want = trained["port"][0][1:], trained["ref"][0][1:]
    assert len(got) == len(trained["params"]) == 2 + LAYERS * 14 + 2
    scale = max(float(np.max(np.abs(w))) for w in want)
    assert scale > 0
    for name, g, w in zip(trained["params"], got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_ATOL_REL * scale, err_msg=name)


def _drain(eng, handle, first, finished):
    toks = list(first)
    while not finished:
        for h, ts, f in eng.step():
            if h is handle:
                toks += ts
                finished = f
    return toks


@pytest.mark.parametrize("prompt", [[1, 2, 3], [7], list(range(3, 13))])
def test_trained_bundle_serves_the_reference_tokens(trained, prompt):
    """The trained test clone, saved by each package, served greedily by
    each package's engine: equal tokens, and the port's ContinuousBatcher
    streams the same ones."""
    want = _drain(*(lambda e: (e, *e.start(prompt, 12)))(
        JaxEngine(trained["ref_dir"], **ENGINE)))
    eng = GenerationEngine(trained["port_dir"], place=tfluid.CPUPlace(),
                           **ENGINE)
    assert _drain(eng, *eng.start(prompt, 12)) == want
    batcher = ContinuousBatcher(eng)
    try:
        assert list(batcher.submit(prompt, 12)) == want
    finally:
        batcher.close()
