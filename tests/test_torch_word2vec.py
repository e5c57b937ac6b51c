"""The port's word2vec slice as a whole against the reference.

tests/book/test_word2vec.py's N-gram model (4 context words looking up one
shared table, concat, fc(sigmoid), fc(softmax over the vocabulary),
mean(cross_entropy)), narrowed to dict 50, emb 8, hidden 16, batch 8 with
ids that repeat within the batch, is built by each package's front end
with ``is_sparse=True`` and ``SGD(fused=True)``. The programs must have
the same ops and variables; the port takes the reference's startup state
by name, and 3 steps must give the same loss and every parameter after
each step in two pairings: the port's ``torch`` route (the unmerged
scatter, the per-parameter expressions) against the reference's ``jnp``
route, and its ``cuda`` route (the kernel wrappers' plain versions on the
CPU: merge + row update, the arena's expression) against the reference's
``pallas`` route (its Pallas kernels in interpret mode). Then the fused
and per-parameter programs bitwise under ``kernel_tier=torch``, the book
test's Adam variant, and the kernel route's wrapper calls per step.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.sparse import is_sparse
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import embedding as tembk
from paddle_tpu_torch.ops.cuda import optimizer as topk
from paddle_tpu_torch.testing.models import ngram_lm

DICT, EMB, HIDDEN, BATCH, N, STEPS = 50, 8, 16, 8, 5, 3
LR = 0.5
# float32 through two fcs, a 50-way softmax and back, sums in another order
# between XLA and PyTorch (and an FMA now and then on XLA's side); the
# tables' rows also take their duplicates' updates in another order on the
# scatter routes. Measured: the losses equal, the parameters and Adam
# moments within 2.9e-7 of their largest element; held to 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_REL = 1e-5


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})
    ttier.reset_fallback_counts()


def _build(fluid, opt="sgd", fused=True):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup):
        words = [fluid.layers.data(f"w{i}", shape=[1], dtype="int64")
                 for i in range(N - 1)]
        nextw = fluid.layers.data("nextw", shape=[1], dtype="int64")
        predict = ngram_lm(words, DICT, emb=EMB, hidden=HIDDEN,
                           is_sparse=True, layers=fluid.layers)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(predict, nextw))
        if opt == "sgd":
            fluid.optimizer.SGD(learning_rate=LR, fused=fused).minimize(
                loss, startup)
        else:
            fluid.optimizer.Adam(learning_rate=0.01, fused=fused).minimize(
                loss, startup)
    return main, startup, loss


def _feed():
    """Ids from 12 of the 50 words, so that they repeat within the batch
    and across the 4 lookups; most table rows are never touched."""
    rng = np.random.RandomState(9)
    grams = rng.choice(12, (BATCH, N)) * 3
    feed = {f"w{i}": grams[:, i:i + 1].astype("int64")
            for i in range(N - 1)}
    feed["nextw"] = grams[:, N - 1:].astype("int64")
    return feed


def _state(main):
    return [v.name for v in main.global_block().vars.values()
            if v.persistable and not v.is_data]


def _trajectory(fluid, main, loss, scope, exe, names):
    """Per step: (loss, {name: value after the step})."""
    out = []
    for _ in range(STEPS):
        lv, = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        out.append((float(np.asarray(lv)),
                    {n: np.array(scope.find_var(n)) for n in names}))
    return out


def _reference(route, opt="sgd", fused=True):
    jfluid.set_flags({"kernel_tier": route})
    main, startup, loss = _build(jfluid, opt, fused)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(startup, scope=scope)
    names = _state(main)
    init = {n: np.array(scope.find_var(n)) for n in names}
    return init, _trajectory(jfluid, main, loss, scope, exe, names)


def _port(route, init, opt="sgd", fused=True):
    tfluid.set_flags({"kernel_tier": route})
    main, _, loss = _build(tfluid, opt, fused)
    scope = tfluid.io.scope_from_numpy(init, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    return _trajectory(tfluid, main, loss, scope, exe, list(init))


def _assert_close(got, want):
    for step, ((gl, gs), (wl, ws)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, **LOSS_TOL,
                                   err_msg=f"loss, step {step + 1}")
        for n, w in ws.items():
            assert gs[n].shape == w.shape, n
            rel = np.abs(gs[n] - w).max() / max(np.abs(w).max(), 1e-30)
            assert rel <= PARAM_REL, (n, step + 1, rel)


def test_programs_have_the_same_ops_and_vars():
    jmain, _, _ = _build(jfluid)
    tmain, _, _ = _build(tfluid)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert sorted(tmain.global_block().vars) == \
        sorted(jmain.global_block().vars)
    shared = [p.name for p in tmain.global_block().all_parameters()]
    assert shared.count("shared_w") == 1
    update, = [op for op in tmain.global_block().ops
               if op.type == "fused_sgd"]
    assert "shared_w" in update.input("Params")


@pytest.mark.parametrize("routes", [("torch", "jnp"), ("cuda", "pallas")])
def test_training_steps_match_reference(routes):
    init, want = _reference(routes[1])
    got = _port(routes[0], init)
    _assert_close(got, want)
    assert got[-1][0] < got[0][0]
    # rows no id of the batch names never move
    fed = np.unique(np.concatenate([v.ravel() for k, v in _feed().items()
                                    if k != "nextw"]))
    untouched = np.setdiff1d(np.arange(DICT), fed)
    np.testing.assert_array_equal(got[-1][1]["shared_w"][untouched],
                                  init["shared_w"][untouched])


def test_fused_program_is_bitwise_the_per_parameter_one():
    """The counterpart of tests/test_fused_optimizer.py:74,90 for SGD:
    under kernel_tier=torch the fused op applies each parameter's own
    expression (the sparse table its scatter), so the two programs'
    losses and states agree bit for bit."""
    init, _ = _reference("jnp")
    fused = _port("torch", init, fused=True)
    per_param = _port("torch", init, fused=False)
    for (fl, fs), (pl, ps) in zip(fused, per_param):
        assert fl == pl
        for n in fs:
            np.testing.assert_array_equal(fs[n], ps[n], err_msg=n)


@pytest.mark.parametrize("fused", [False, True], ids=["per_param", "fused"])
def test_adam_variant_of_the_book_test(fused):
    """The repo's book test trains this model with Adam(0.01) and
    is_sparse=True: the lazy sparse branch for shared_w, the dense one
    for the fcs; against the reference's run of the same program."""
    init, want = _reference("jnp", opt="adam", fused=fused)
    got = _port("torch", init, opt="adam", fused=fused)
    _assert_close(got, want)
    assert got[-1][0] < got[0][0]


def test_kernel_route_calls_each_wrapper_once_a_step(monkeypatch):
    """Under kernel_tier=cuda a step calls embedding_sgd once (shared_w,
    its 4 lookups' gradients concatenated by the backward's sum) and
    sgd_arena once (the 4 fc tensors), and nothing falls back; the
    gradient reaching the update is a SparseRows of 4 x batch entries."""
    calls = {"embedding_sgd": 0, "sgd_arena": 0}

    def counted(module, name):
        real = getattr(module, name)

        def fn(*args):
            calls[name] += 1
            return real(*args)
        monkeypatch.setattr(module, name, fn)

    counted(tembk, "embedding_sgd")
    counted(topk, "sgd_arena")
    tfluid.set_flags({"kernel_tier": "cuda"})
    main, startup, loss = _build(tfluid)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    ttier.reset_fallback_counts()
    for step in range(STEPS):
        lv, g = exe.run(main, feed=_feed(),
                        fetch_list=[loss, "shared_w@GRAD"], scope=scope)
        assert is_sparse(g) and g.rows.shape == ((N - 1) * BATCH,)
    assert calls == {"embedding_sgd": STEPS, "sgd_arena": STEPS}
    assert ttier.fallback_counts() == {}
