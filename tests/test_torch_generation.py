"""The port's generation engine against the reference's, on one bundle the
reference package exports (its tests' tiny LM: vocab 17, emb 8, 2 heads,
2 layers), and the port's own token-stream pins.

Across packages: the bundle loads into the port's ``GenerationEngine``
on the CPU; the prefill and every teacher-forced decode step's logits
match the reference engine's; greedy tokens equal the reference engine's
and the port's own full-window decode. Within the port (the counterparts
of tests/test_generation_serving.py and tests/test_prefix_cache.py):
continuous = sequential for greedy, seeded top-k and beam; cached prefix
= cold; chunked = unchunked, interleaved with decode; ``donate_arena`` on
= off; typed admission errors; the ContinuousBatcher's queueing,
overload and cancel; and the kernel route's wrapper calls per decode
dispatch.
"""

import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.serving import GenerationEngine as JaxEngine
from paddle_tpu.testing.models import export_tiny_lm
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import paged_attention as pak
from paddle_tpu_torch.serving import (CacheExhausted, ContinuousBatcher,
                                      GenerationEngine, NoFreeSlots,
                                      ServerOverloaded)
from paddle_tpu_torch.testing import models as tmodels

VOCAB = 17
# logits of the two packages: float32 GEMMs and einsums summed in other
# orders through 2 layers with layer norms; the logits are O(1)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
ENGINE = dict(max_seqs=4, block_size=4, num_blocks=64, max_len=32,
              prefill_buckets=(8, 16))


@pytest.fixture(autouse=True)
def _reset():
    ttier.reset_fallback_counts()
    yield
    tfluid.set_flags({"kernel_tier": "auto"})
    ttier.reset_fallback_counts()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_genlm") / "model")
    export_tiny_lm(d, vocab=VOCAB, emb=8, heads=2, n_layers=2, max_pos=64,
                   seed=3)
    return d


def _engine(d, **kw):
    return GenerationEngine(d, place=tfluid.CPUPlace(), **{**ENGINE, **kw})


def _drain(eng, handle, first, finished):
    toks = list(first)
    while not finished:
        stepped = eng.step()
        assert stepped, "engine.step() stalled with an active sequence"
        for h, ts, f in stepped:
            if h is handle:
                toks += ts
                finished = f
    return toks


def _run_requests(eng, requests, sequential):
    """Drive requests one at a time (sequential) or all in flight
    (continuous); returns each request's token stream."""
    if sequential:
        return [_drain(eng, *eng.start(p, m, s)) for p, m, s in requests]
    streams = [[] for _ in requests]
    live = {}
    for i, (p, m, s) in enumerate(requests):
        h, first, fin = eng.start(p, m, s)
        streams[i] += first
        if not fin:
            live[id(h)] = i
    while live:
        for h, ts, f in eng.step():
            i = live.get(id(h))
            if i is None:
                continue
            streams[i] += ts
            if f:
                del live[id(h)]
    return streams


def _full_window_greedy(d, prompt, max_new):
    """Teacher-free argmax decode through the port's UNSPLIT saved program
    (every step the whole window)."""
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    program, _, fetches = tfluid.io.load_inference_model(d, exe, scope=scope)
    toks, out = list(prompt), []
    for _ in range(max_new):
        t = len(toks)
        lg = exe.run(program, feed={
            "tokens": np.asarray(toks, np.int64).reshape(1, t, 1),
            "positions": np.arange(t, dtype=np.int64).reshape(1, t, 1)},
            fetch_list=fetches, scope=scope)[0]
        out.append(int(np.argmax(lg[0, -1])))
        toks.append(out[-1])
    return out


def test_bundle_loads_with_the_reference_parameters(bundle):
    """load_inference_model reads the reference's bundle; the engine's
    private scope carries every parameter bitwise, on the CPU."""
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jprog, _, _ = jfluid.io.load_inference_model(bundle, jexe, scope=jscope)
    eng = _engine(bundle)
    names = [v.name for v in jprog.global_block().vars.values()
             if v.persistable and not v.is_data]
    assert len(names) == 2 + 2 * 14 + 2     # 5 fc + 2 layer_norm a layer
    for n in names:
        got = eng._scope.find_var(n)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jscope.find_var(n)))
    assert (eng.num_layers, eng.cache.num_heads, eng.cache.head_dim) == \
        (2, 2, 4)


def test_engine_over_scope_from_numpy_of_reference_parameters(
        bundle, reference_streams):
    """The reference scope's parameters carried over as numpy arrays
    (``scope_from_numpy``, the weight-carrying path) into an engine built
    from a program and a scope instead of a bundle directory: the same
    greedy tokens."""
    jscope = jfluid.Scope()
    jfluid.io.load_inference_model(bundle, jfluid.Executor(jfluid.CPUPlace()),
                                   scope=jscope)
    arrays = {n: np.asarray(jscope.find_var(n))
              for n in jscope.local_names()}
    scope = tfluid.io.scope_from_numpy(arrays, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    program, feeds, fetches = tfluid.io.load_inference_model(
        bundle, exe, scope=tfluid.Scope())
    eng = GenerationEngine(program=program, feed_names=feeds,
                           fetch_vars=fetches, executor=exe, scope=scope,
                           **ENGINE)
    assert _drain(eng, *eng.start([1, 2, 3], 8)) == \
        reference_streams[(1, 2, 3)]


def _teacher_forced_logits(eng, prompt, forced):
    """Prefill ``prompt``, then feed ``forced`` tokens one decode step at a
    time whatever the logits say; returns every step's logits."""
    seen = []

    def sample(seq, logits):
        seen.append(np.array(logits, np.float32))
        return forced[len(seen) - 1]

    eng._sample = sample
    _drain(eng, *eng.start(prompt, len(forced)))
    return np.stack(seen)


@pytest.mark.parametrize("prompt", [[1, 2, 3], list(range(1, 11))])
def test_prefill_and_decode_logits_match_reference_engine(bundle, prompt):
    forced = [5, 0, 16, 3, 3, 9, 12, 1]
    want = _teacher_forced_logits(JaxEngine(bundle, **ENGINE), prompt,
                                  forced)
    got = _teacher_forced_logits(_engine(bundle), prompt, forced)
    assert got.shape == (len(forced), VOCAB)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.fixture(scope="module")
def reference_streams(bundle):
    """The reference engine's greedy streams for a few prompts."""
    eng = JaxEngine(bundle, **ENGINE)
    eng.warmup()
    return {tuple(p): _drain(eng, *eng.start(p, 8))
            for p in ([1, 2, 3], [5], list(range(1, 11)))}


@pytest.mark.parametrize("prompt", [[1, 2, 3], [5], list(range(1, 11))])
def test_greedy_tokens_equal_reference_and_full_window(bundle,
                                                       reference_streams,
                                                       prompt):
    eng = _engine(bundle)
    assert eng.warmup() == 3             # decode + two prefill buckets
    toks = _drain(eng, *eng.start(prompt, 8))
    assert toks == reference_streams[tuple(prompt)]
    assert toks == _full_window_greedy(bundle, prompt, 8)
    st = eng.stats()
    assert st["active_sequences"] == 0 and st["blocks_in_use"] == 0
    assert st["phases"]["decode"][4]["dispatches"] == 1 + 7
    assert st["kernel_tier"] == "torch"


REQUESTS = [
    ([1, 2], 5, None),
    ([5], 7, {"mode": "topk", "top_k": 4, "seed": 11}),
    ([7, 8, 9, 10], 4, {"mode": "beam", "beam_size": 2, "eos_id": 0}),
    ([2, 4, 6], 6, {"mode": "topk", "top_k": 3, "seed": 5,
                    "temperature": 0.7}),
]


@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_continuous_equals_sequential_greedy_topk_beam(bundle, route):
    """Joining a running ragged batch changes no sequence's tokens, on
    both routes, and a fresh run reproduces the seeded top-k."""
    tfluid.set_flags({"kernel_tier": route})
    eng = _engine(bundle, max_seqs=5)
    eng.warmup()
    seq = _run_requests(eng, REQUESTS, sequential=True)
    cont = _run_requests(eng, REQUESTS, sequential=False)
    assert seq == cont
    assert _run_requests(eng, REQUESTS, sequential=False) == cont
    st = eng.stats()
    assert st["active_sequences"] == 0 and st["blocks_in_use"] == 0
    assert st["fallbacks"] == {}


def test_token_streams_equal_reference_engine_for_all_modes(bundle):
    want = _run_requests(JaxEngine(bundle, **{**ENGINE, "max_seqs": 5}),
                         REQUESTS, sequential=False)
    got = _run_requests(_engine(bundle, max_seqs=5), REQUESTS,
                        sequential=False)
    assert got == want


def test_beam_emits_best_hypothesis_once(bundle):
    eng = _engine(bundle)
    h, first, fin = eng.start([1, 2, 3], 5, {"mode": "beam",
                                             "beam_size": 3})
    assert first == [] and not fin
    toks = _drain(eng, h, first, fin)
    assert len(toks) == 5 and all(0 <= t < VOCAB for t in toks)
    assert eng.stats()["blocks_in_use"] == 0


PREFIX_REQUESTS = [
    (list(range(1, 11)), 5, None),
    (list(range(1, 11)), 6, {"mode": "topk", "top_k": 4, "seed": 11}),
    (list(range(1, 11)), 4, {"mode": "beam", "beam_size": 2, "eos_id": 0}),
]


@pytest.fixture(scope="module")
def cold_streams(bundle):
    eng = _engine(bundle)
    return [_drain(eng, *eng.start(p, m, s)) for p, m, s in PREFIX_REQUESTS]


def test_cached_prefix_equals_cold(bundle, cold_streams):
    eng = _engine(bundle, prefix_cache_blocks=16)
    assert eng.warmup() == 5             # + a chunked phase per bucket
    first = [_drain(eng, *eng.start(p, m, s)) for p, m, s in PREFIX_REQUESTS]
    assert first == cold_streams
    hits0 = eng.cache.prefix_hits
    second = [_drain(eng, *eng.start(p, m, s))
              for p, m, s in PREFIX_REQUESTS]
    assert second == cold_streams
    assert eng.cache.prefix_hits > hits0
    st = eng.stats()
    assert st["active_sequences"] == 0 and st["cache"]["blocks_cached"] > 0
    assert st["phases"]["chunk"]


def test_chunked_equals_unchunked_and_interleaves(bundle, cold_streams):
    prompt, max_new = PREFIX_REQUESTS[0][:2]
    eng = _engine(bundle, prefill_chunk=4)
    eng.warmup()
    h_short, first_s, fin_s = eng.start([1, 2], 10)
    h_long, first_l, fin_l = eng.start(prompt, max_new)
    assert first_l == [] and not fin_l
    assert eng.stats()["prefilling"] == 1
    toks_short, toks_long, short_before_long = list(first_s), [], None
    while not (fin_s and fin_l):
        for h, ts, f in eng.step():
            if h is h_short:
                toks_short += ts
                fin_s = f
            elif h is h_long:
                if short_before_long is None:
                    short_before_long = len(toks_short)
                toks_long += ts
                fin_l = f
    # a 10-token prompt at chunk 4: 3 step boundaries the short sequence
    # decoded through before the long one emitted
    assert short_before_long is not None and short_before_long >= 3
    assert toks_long == cold_streams[0]
    assert len(toks_short) == 10
    assert eng.stats()["active_sequences"] == 0


def test_abort_mid_chunked_prefill_frees_everything(bundle):
    eng = _engine(bundle, prefill_chunk=4)
    for sampling in (None, {"mode": "beam", "beam_size": 2}):
        h, _, fin = eng.start(list(range(1, 11)), 6, sampling)
        assert not fin
        eng.step()
        eng.abort(h)
        st = eng.stats()
        assert st["active_sequences"] == 0 and st["prefilling"] == 0
        assert st["blocks_in_use"] == 0


def test_donate_arena_on_equals_off(bundle):
    """Feeding the arena itself (updated in place) or clones of it gives
    the same token streams; without donation the arena tensors are new
    objects after a dispatch."""
    on = _engine(bundle, max_seqs=5)
    off = _engine(bundle, max_seqs=5, donate_arena=False)
    k_on, k_off = on.cache.k[0], off.cache.k[0]
    assert _run_requests(on, REQUESTS, False) == \
        _run_requests(off, REQUESTS, False)
    assert on.cache.k[0] is k_on and off.cache.k[0] is not k_off
    assert on.stats()["donate_arena"] and not off.stats()["donate_arena"]


def test_admission_errors_are_typed(bundle):
    eng = _engine(bundle, max_seqs=2, num_blocks=4)
    with pytest.raises(ValueError, match="max_len"):
        eng.start([1], 99)
    h, _, fin = eng.start([1, 2], 10)
    assert not fin
    with pytest.raises(CacheExhausted):
        eng.start([3], 10)
    h2, _, fin2 = eng.start([3], 2)
    with pytest.raises(NoFreeSlots):
        eng.start([4], 2)
    eng.abort(h)
    if not fin2:
        eng.abort(h2)
    assert eng.stats()["active_sequences"] == 0
    eng.start([3], 4)
    with pytest.raises(ValueError, match="decode slots"):
        eng.start([1], 4, {"mode": "beam", "beam_size": 3})
    with pytest.raises(ValueError, match="never be admitted"):
        eng.start([1, 2], 28)


def test_kernel_route_calls_the_wrapper_once_per_layer_per_decode(
        bundle, monkeypatch):
    """Under kernel_tier=cuda every decode dispatch calls the
    paged-attention wrapper num_layers times (its plain version on CPU
    tensors), and nothing falls back; prefill never calls it."""
    calls = [0]
    real = pak.paged_attention_cuda

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(pak, "paged_attention_cuda", counted)
    tfluid.set_flags({"kernel_tier": "cuda"})
    eng = _engine(bundle)
    eng.warmup()
    calls[0] = 0
    toks = _drain(eng, *eng.start([1, 2, 3], 8))
    decodes = eng.stats()["phases"]["decode"][4]["dispatches"] - 1
    assert decodes == 7
    assert calls[0] == eng.num_layers * decodes
    assert ttier.fallback_counts() == {}
    assert eng.stats()["kernel_tier"] == "cuda"
    tfluid.set_flags({"kernel_tier": "torch"})
    plain = _engine(bundle)
    assert _drain(plain, *plain.start([1, 2, 3], 8)) == toks


def test_tiny_lm_builds_the_reference_program():
    """The port's build_tiny_lm appends the reference's ops, attrs and
    parameter names in the same order."""
    from paddle_tpu.fluid import framework as jframework
    from paddle_tpu.testing.models import build_tiny_lm
    jframework.reset_unique_name()
    jmain, _, jlogits = build_tiny_lm(vocab=VOCAB, emb=8, heads=2,
                                      n_layers=2)
    tfluid.reset_unique_name()
    tmain, _, tlogits = tmodels.build_tiny_lm(vocab=VOCAB, emb=8, heads=2,
                                              n_layers=2)
    j, t = jmain.global_block(), tmain.global_block()
    assert [(o.type, o.inputs, o.outputs, o.attrs) for o in t.ops] == \
        [(o.type, o.inputs, o.outputs, o.attrs) for o in j.ops]
    assert [p.name for p in tmain.all_parameters()] == \
        [p.name for p in jmain.all_parameters()]
    assert tlogits.name == jlogits.name


def test_port_exported_bundle_serves(tmp_path):
    """export_tiny_lm through the port itself: startup on the CPU, save,
    serve."""
    d = str(tmp_path / "m")
    tfluid.reset_unique_name()
    tmodels.export_tiny_lm(d, place=tfluid.CPUPlace(), vocab=VOCAB, emb=8,
                           heads=2, n_layers=1, max_pos=32)
    eng = _engine(d, max_len=16, prefill_buckets=(8,))
    toks = _drain(eng, *eng.start([1, 2], 6))
    assert toks == _full_window_greedy(d, [1, 2], 6)


# ---------------------------------------------------------------------------
# ContinuousBatcher
# ---------------------------------------------------------------------------

def test_batcher_queues_past_capacity_and_completes_fifo(bundle):
    eng = _engine(bundle, max_seqs=2)
    b = ContinuousBatcher(eng, capacity=8)
    try:
        streams = [b.submit([1 + i, 2], 4 + i % 3) for i in range(6)]
        for i, s in enumerate(streams):
            assert len(list(s)) == 4 + i % 3
        st = b.stats()
        assert st["requests"] == 6 and st["rejected"] == 0
        assert st["in_flight"] == 0 and st["queue_depth"] == 0
        assert st["ttft"]["count"] == 6 and st["tpot"]["count"] == 6
    finally:
        assert b.close()


def test_batcher_continuous_equals_gang_and_sequential(bundle):
    eng = _engine(bundle, max_seqs=3)
    reqs = [([1 + i, 2 + i % 3, 3], 3 + i % 4) for i in range(7)]
    want = [_drain(eng, *eng.start(p, m)) for p, m in reqs]
    for continuous in (True, False):
        b = ContinuousBatcher(eng, continuous=continuous)
        try:
            streams = [b.submit(p, m) for p, m in reqs]
            assert [list(s) for s in streams] == want
        finally:
            assert b.close()


def test_batcher_overload_rejects_fast_typed(bundle):
    eng = _engine(bundle, max_seqs=1)
    b = ContinuousBatcher(eng, capacity=1)
    try:
        s1 = b.submit([1, 2], 20)
        deadline = time.monotonic() + 10
        while b.stats()["in_flight"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        b.submit([3], 4)
        with pytest.raises(ServerOverloaded):
            b.submit([4], 4)
        assert b.stats()["rejected"] == 1
        assert len(list(s1)) == 20
    finally:
        b.close()


def test_batcher_cancel_frees_capacity(bundle):
    eng = _engine(bundle, max_seqs=1)
    b = ContinuousBatcher(eng, capacity=4)
    try:
        s1 = b.submit([1, 2], 25)
        next(iter(s1))
        s2 = b.submit([3], 3)
        s1.close()
        assert len(list(s2)) == 3
        assert eng.stats()["active_sequences"] == 0
    finally:
        b.close()


def test_batcher_bad_requests_fail_their_own_stream(bundle):
    eng = _engine(bundle, max_seqs=2, num_blocks=4)
    b = ContinuousBatcher(eng)
    try:
        with pytest.raises(ValueError, match="mode"):
            b.submit([1], 4, {"mode": "nucleus"})
        assert b.stats()["queue_depth"] == 0
        bad = b.submit([1], 4, {"mode": "beam", "beam_size": 3})
        good = b.submit([2, 3], 4)
        with pytest.raises(ValueError, match="decode slots"):
            list(bad)
        assert len(list(good)) == 4
    finally:
        b.close()
