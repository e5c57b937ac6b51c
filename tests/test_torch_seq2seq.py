"""The Seq2Seq NMT model of tests/book/test_machine_translation.py in the
port (``paddle_tpu_torch.testing.models.nmt_*``), against the reference.

At the book test's widths (dictionaries 24, embedding 24, hidden 48, beam
3, 8 decode steps, batch 16): the port's train and decode programs have
the reference's ops and variables; from the reference's startup state, 20
Adam steps on the same batches give the reference's losses within
LOSS_RTOL (the port's plain route against the reference's jnp route);
then, on the reference's trained parameters, the beam decode gives the
same ids and 2-level LoD and scores within SCORE_RTOL. The port's kernel
route (the kernel wrappers' plain versions on the CPU) calls lstm_seq,
lstm_seq_bwd, gru_seq and gru_seq_bwd once a step each with no fallback.
The gru op with a nonzero H0 and a row of length 0 agrees with the
reference on both routes, and that row carries H0 unchanged. The book
test itself, on the port: train on the port's own synthetic pairs until
the loss is under 0.3 of the first, then at least 70% of the beam decodes
are right. The ``cuda`` cases hold gru_seq_bwd's dh0 with a nonzero h0
against gru_seq_bwd_torch on the card.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import rnn as trnn
from paddle_tpu_torch.testing import models

from torch_cross import assert_close, build_both, host, port_scope, \
    ref_state

DICT, EMB, HID, BEAM, MAX_LEN, BATCH = 24, 24, 48, 3, 8, 16
STEPS = 20
# float32 through an LSTM, a GRU and a softmax over 24 words, then Adam at
# 0.01: the packages' sums and transcendental roundings differ by float32
# steps, which Adam's normalisation carries into the weights; the 20
# steps measured within 1.8e-7 relative
LOSS_RTOL = 1e-4
# the decode's accumulated log-probs over 8 steps of the same parameters
# (measured 1.4e-7 of the largest)
SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _train(fluid):
    return models.nmt_train_program(fluid, DICT, DICT, EMB, HID)


def _decode(fluid):
    return models.nmt_decode_program(fluid, BATCH, DICT, DICT, EMB, HID,
                                     BEAM, MAX_LEN)


def _samples():
    """The reference book test's pool: the synthetic task's triples with
    a core of at most 4 tokens."""
    return [s for s in models.nmt_pairs(600, 0, DICT, vocab=33)
            if len(s[0]) <= 6]


def _batches(n, seed=0):
    samples = _samples()
    rng = np.random.RandomState(seed)
    return [[samples[i] for i in rng.randint(0, len(samples), BATCH)]
            for _ in range(n)]


def _decode_feed(triples):
    init_scores = np.zeros((BATCH, BEAM), "float32")
    init_scores[:, 1:] = -1e9
    return {"src": [np.asarray(t[0], "int64").reshape(-1, 1)
                    for t in triples],
            "init_ids": np.full((BATCH, BEAM), models.NMT_BOS, "int64"),
            "init_scores": init_scores,
            "state_seed": np.zeros((BATCH, BEAM, HID), "float32")}


def test_programs_have_the_reference_ops_and_vars():
    for build in (_train, _decode):
        progs = build_both(build)
        for j, t in zip(progs["ref"][0].blocks, progs["port"][0].blocks):
            assert [op.type for op in t.ops] == [op.type for op in j.ops]
            assert sorted(t.vars) == sorted(j.vars)


def _params(main):
    return [p.name for p in main.global_block().all_parameters()]


def test_training_and_decode_match_reference():
    jfluid.set_flags({"kernel_tier": "jnp"})
    tfluid.set_flags({"kernel_tier": "torch"})
    train = build_both(_train)
    decode = build_both(_decode)
    jmain, jstartup, jloss, _ = train["ref"]
    tmain, _, tloss, _ = train["port"]
    jexe, jscope, state = ref_state(jmain, jstartup)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = port_scope(state)
    want, got = [], []
    for triples in _batches(STEPS):
        feed = models.nmt_feed(triples)
        want.append(float(np.asarray(jexe.run(
            jmain, feed=feed, fetch_list=[jloss], scope=jscope)[0])))
        got.append(float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                                  scope=tscope)[0]))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]

    # decode on the reference's trained parameters in both packages
    trained = {n: np.array(jscope.find_var(n)) for n in _params(jmain)}
    feed = _decode_feed(_batches(1, seed=1)[0])
    fetch = [decode["ref"][2].name, decode["ref"][3].name]
    w = [host(v) for v in jexe.run(decode["ref"][0], feed=feed,
                                   fetch_list=fetch, scope=jscope)]
    g = [host(v) for v in texe.run(decode["port"][0], feed=feed,
                                   fetch_list=fetch,
                                   scope=port_scope(trained))]
    assert len(g[0][1]) == 2 and g[0][1][0] == list(range(
        0, BATCH * BEAM + 1, BEAM))
    assert_close(g[0], w[0], 0, 0, "sentence ids")
    assert_close(g[1], w[1], SCORE_RTOL, 0, "sentence scores")


def test_kernel_route_calls_each_recurrent_kernel_once_a_step(monkeypatch):
    """Under kernel_tier=cuda (the wrappers' plain versions on the CPU) a
    training step calls lstm_seq, lstm_seq_bwd, gru_seq and gru_seq_bwd
    once each, with no fallback, and H0@GRAD is not zero."""
    calls = {}

    def counted(name):
        real = getattr(trnn, name)

        def fn(*args):
            calls[name] = calls.get(name, 0) + 1
            return real(*args)
        monkeypatch.setattr(trnn, name, fn)

    for name in ("lstm_seq", "lstm_seq_bwd", "gru_seq", "gru_seq_bwd"):
        counted(name)
    tfluid.set_flags({"kernel_tier": "cuda"})
    tfluid.framework.reset_unique_name()
    main, startup, loss, v = _train(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    ttier.reset_fallback_counts()
    for step, triples in enumerate(_batches(2)):
        calls.clear()
        _, dh0 = exe.run(main, feed=models.nmt_feed(triples),
                         fetch_list=[loss, v["boot"].name + "@GRAD"],
                         scope=scope)
        assert calls == {"lstm_seq": 1, "lstm_seq_bwd": 1, "gru_seq": 1,
                         "gru_seq_bwd": 1}, (step, calls)
        assert np.abs(dh0).max() > 0
    assert ttier.fallback_counts() == {}


def _gru_h0(fluid, hid=16):
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        x = layers.data("x", shape=[3 * hid], lod_level=1)
        h0 = layers.data("h0", shape=[hid])
        x.stop_gradient = h0.stop_gradient = False
        h = layers.dynamic_gru(x, size=hid, h_0=h0)
        loss = layers.mean(layers.square(h))
        fluid.append_backward(loss)
    return main, startup, h


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_gru_with_h0_and_an_empty_row(route):
    """The gru op with a nonzero H0 over rows of lengths 5, 0, 3: Hidden
    and the grads of x, H0 and W against the reference's jnp route (the
    cuda route runs the kernel wrappers' plain versions, whose bf16
    products the reference's pallas recipe shares: held to the card
    limits' 1e-2). The empty row's H0@GRAD is zero (no step reads it) and
    the next op sees no output for it."""
    rng = np.random.RandomState(4)
    hid = 16
    feed = {"x": [rng.normal(0, 1, (n, 3 * hid)).astype("float32")
                  for n in (5, 0, 3)],
            "h0": rng.normal(0, 1, (3, hid)).astype("float32")}
    jfluid.set_flags({"kernel_tier": {"torch": "jnp",
                                      "cuda": "pallas"}[route]})
    tfluid.set_flags({"kernel_tier": route})
    progs = build_both(_gru_h0)
    tfluid.framework.reset_unique_name()
    params = _params(progs["port"][0])
    fetch = [progs["port"][2].name, "x@GRAD", "h0@GRAD"] \
        + [p + "@GRAD" for p in params]
    jexe, jscope, state = ref_state(*progs["ref"][:2])
    want = [host(v) for v in jexe.run(progs["ref"][0], feed=feed,
                                      fetch_list=fetch, scope=jscope)]
    got = [host(v) for v in tfluid.Executor(tfluid.CPUPlace()).run(
        progs["port"][0], feed=feed, fetch_list=fetch,
        scope=port_scope(state))]
    tol = (1e-5, 1e-6) if route == "torch" else (1e-2, 1e-4)
    for name, g, w in zip(fetch, got, want):
        assert_close(g, w, *tol, name)
    np.testing.assert_array_equal(got[2][1], 0)
    assert np.abs(got[2][0]).max() > 0
    assert got[0][1] == [[0, 5, 5, 8]]


def test_book_machine_translation_on_the_port():
    """tests/book/test_machine_translation.py on the port: train on the
    port's synthetic pairs (Adam 0.01, batch 16) until the loss is under
    0.1 or 400 steps, which must bring it under 0.3 of the first; then the
    beam decode's best beam is the target for at least 70% of a batch."""
    tfluid.framework.reset_unique_name()
    main, startup, loss, _ = _train(tfluid)
    dmain, dstartup, sent_ids, _, _ = _decode(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(dstartup, scope=scope)
    exe.run(startup, scope=scope)
    first = last = None
    for triples in _batches(400):
        last = float(exe.run(main, feed=models.nmt_feed(triples),
                             fetch_list=[loss], scope=scope)[0])
        first = last if first is None else first
        if last < 0.1:
            break
    assert last < 0.3 * first, (first, last)
    triples = _batches(1, seed=1)[0]
    ids = exe.run(dmain, feed=_decode_feed(triples), fetch_list=[sent_ids],
                  scope=scope)[0]
    flat, lod = tfluid.lodarray_to_flat(ids)
    assert len(lod) == 2
    correct = 0
    for i, t in enumerate(triples):
        seq = flat[lod[-1][i * BEAM]:lod[-1][i * BEAM + 1], 0]
        assert seq[0] == models.NMT_BOS
        seq = seq[1:]
        if len(seq) and seq[-1] == models.NMT_EOS:
            seq = seq[:-1]
        trg = np.asarray(t[2][:-1])
        correct += len(seq) == len(trg) and bool(np.all(seq == trg))
    assert correct >= BATCH * 0.7, f"{correct}/{BATCH}"


# ---------------------------------------------------------------------------
# the card: gru_seq_bwd's dh0 with a nonzero h0
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_seq2seq.py on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("b,L,hdim", [(64, 52, 512), (16, 10, 48)])
def test_gru_seq_bwd_dh0_on_card(b, L, hdim):
    """The NMT decoder's shape (batch 64, targets up to 52 tokens, H 512)
    and the book test's: h0 a tanh of a normal draw (as the boot fc
    gives), lengths 2..L with one row of length 0. dh0 against
    gru_seq_bwd_torch within phase 7's gru_seq_bwd limits (‖Δ‖∞ 1e-2 of
    the largest, ‖Δ‖₂ 4e-3), nonzero, bitwise on a repeat, and zero on the
    empty row."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    lens = torch.randint(2, L + 1, (b,), generator=gen, device="cuda")
    lens[0], lens[1] = L, 0
    alive = (torch.arange(L, device="cuda")[:, None] < lens[None, :]) \
        .float()[..., None].contiguous()
    x = torch.randn(L, b, 3 * hdim, generator=gen, device="cuda")
    w = torch.randn(hdim, 3 * hdim, generator=gen, device="cuda") * 0.05
    h0 = torch.tanh(torch.randn(b, hdim, generator=gen, device="cuda"))
    dhs = (torch.randn(L, b, hdim, generator=gen, device="cuda")
           * alive).contiguous()
    hs = trnn.gru_seq(x, alive, w, h0)
    dx, dw, dh0 = trnn.gru_seq_bwd(x, alive, w, h0, hs, dhs)
    again = trnn.gru_seq_bwd(x, alive, w, h0, hs, dhs)[2]
    ref = trnn.gru_seq_bwd_torch(x, alive, w, h0, hs, dhs)[2]
    torch.cuda.synchronize()
    assert torch.equal(dh0, again)
    d = dh0 - ref
    assert (d.abs().max() / ref.abs().max()).item() <= 1e-2
    assert (d.norm() / ref.norm()).item() <= 4e-3
    assert dh0.abs().max().item() > 0
    assert torch.equal(dh0[1], torch.zeros_like(dh0[1]))
