"""The port's LSTM text-classification slice as a whole against the
reference.

bench.py:239's network, narrowed (vocab 50, emb 8, hidden 16, 2 LSTM
layers, 2 classes), is built by each package's front end with
mean(cross_entropy) and Adam(2e-3, fused=True). The programs must have the
same ops and variables; the port takes the reference's startup state by
name, and 3 steps on one ragged batch of 4 (lengths 1..9) must give the
same losses and final parameters in two pairings: the port's ``torch``
route against the reference's ``jnp`` route (float32 scans), and its
``cuda`` route (every kernel wrapper's plain version, on the CPU) against
the reference's ``pallas`` route (the Pallas kernels in interpret mode).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.lod import pack_sequences as jpack
from paddle_tpu_torch.core.lod import pack_sequences as tpack
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import optimizer as topk
from paddle_tpu_torch.ops.cuda import rnn as trnn
from paddle_tpu_torch.testing.models import lstm_textcls

VOCAB, EMB, HIDDEN, BATCH, STEPS = 50, 8, 16, 4, 3
LENS = (9, 4, 1, 6)
# losses: float32 through two LSTMs and back, sums in other orders and
# sigmoid/tanh a float32 step apart between XLA and PyTorch; measured
# within 2e-7 relative, held to 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=0)
# parameters and Adam moments after 3 steps at lr 2e-3, max|Δ| / max|ref|
# per variable. torch vs jnp: float32 roundings only, measured ≤ 2.1e-6.
# cuda vs pallas: each step's recurrent dW_t is rounded to bfloat16, and a
# float32 step of difference upstream can carry an element across a
# rounding boundary, which moves it by 2^-8 (3.9e-3) of itself; the first
# moment takes a tenth of that per step: measured 2.0e-4 on the first
# LSTM's moment1, ≤ 2.8e-5 on every other variable
STATE_REL = {"torch": 1e-5, "cuda": 1e-3}


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _build(fluid):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        prob = lstm_textcls(words, vocab=VOCAB, emb=EMB, hidden=HIDDEN,
                            layers=fluid.layers)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
        fluid.optimizer.Adam(learning_rate=2e-3, fused=True).minimize(
            loss, startup)
    return main, startup, loss


def _batch():
    rng = np.random.RandomState(5)
    seqs = [rng.randint(0, VOCAB, (n, 1)).astype("int64") for n in LENS]
    return seqs, rng.randint(0, 2, (BATCH, 1)).astype("int64")


def _reference(route):
    """The reference's startup state, its losses and its final state."""
    jfluid.set_flags({"kernel_tier": route})
    main, startup, loss = _build(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    state = [v.name for v in main.global_block().vars.values()
             if v.persistable and not v.is_data]
    init = {n: np.array(scope.find_var(n)) for n in state}
    seqs, label = _batch()
    feed = {"words": jpack(seqs), "label": label}
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]))
              for _ in range(STEPS)]
    final = {n: np.array(scope.find_var(n)) for n in state}
    return main, init, losses, final


def test_programs_have_the_same_ops_and_vars():
    jmain, _, _ = _build(jfluid)
    tmain, _, _ = _build(tfluid)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert sorted(tmain.global_block().vars) == \
        sorted(jmain.global_block().vars)


@pytest.mark.parametrize("routes", [("torch", "jnp"), ("cuda", "pallas")])
def test_training_steps_match_reference(routes, monkeypatch):
    _, init, want_losses, want_final = _reference(routes[1])
    tfluid.set_flags({"kernel_tier": routes[0]})
    calls = {"lstm_seq": 0, "lstm_seq_bwd": 0, "adam_arena": 0}

    def counted(module, name):
        real = getattr(module, name)

        def fn(*args):
            calls[name] += 1
            return real(*args)
        monkeypatch.setattr(module, name, fn)

    counted(trnn, "lstm_seq")
    counted(trnn, "lstm_seq_bwd")
    counted(topk, "adam_arena")
    main, _, loss = _build(tfluid)
    scope = tfluid.io.scope_from_numpy(init, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    seqs, label = _batch()
    feed = {"words": tpack(seqs), "label": label}
    ttier.reset_fallback_counts()
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(STEPS)]
    assert ttier.fallback_counts() == {}
    # the kernel route's wrappers per step: one forward and one backward
    # per LSTM layer (the grad op replays the forward's carries), one
    # arena update
    per_step = {"torch": (0, 0, 0), "cuda": (2, 2, 1)}[routes[0]]
    assert tuple(calls.values()) == tuple(STEPS * n for n in per_step)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    assert losses[-1] < losses[0]
    for name, want in want_final.items():
        got = scope.find_var(name).numpy()
        assert got.shape == want.shape, name
        rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert rel <= STATE_REL[routes[0]], (name, rel)
