"""The port's Adam against the reference's: the per-parameter ``adam`` op,
the variadic ``fused_adam`` op on both routes, the arena kernel module's
plain version against ``adam_arena_pallas`` (interpret mode), and the
fused and per-parameter programs against each other, bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.ops.pallas import optimizer as jax_opk
from paddle_tpu_torch.ops.cuda import optimizer as opk

SHAPES = [(3, 5), (1037,), (7, 3, 2), (1,), (2049,)]
LR, B1, B2, EPS = 2e-3, 0.9, 0.999, 1e-8
# both evaluate the same float32 expression; XLA on the CPU may contract a
# multiply and an add into one fused multiply-add, which rounds once
# instead of twice, and that difference passes through the division: a few
# float32 steps of the result
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _state(seed=0, step=3):
    """Params, grads, moments (m2 ≥ 0) and the beta powers at ``step``."""
    rng = np.random.RandomState(seed)
    ps, gs, m1s = ([rng.normal(0, 1, s).astype("float32") for s in SHAPES]
                   for _ in range(3))
    m2s = [np.abs(rng.normal(0, 1e-3, s)).astype("float32") for s in SHAPES]
    pows = [np.array([b ** step], "float32") for b in (B1, B2)]
    return ps, gs, m1s, m2s, pows


def _run(fluid, op_type, inputs, outputs, feeds):
    prog = fluid.Program()
    block = prog.global_block()
    for name, arr in feeds.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
    fetch = [n for names in outputs.values() for n in names]
    block.append_op(op_type, inputs=inputs, outputs=outputs,
                    attrs={"beta1": B1, "beta2": B2, "epsilon": EPS})
    return [np.asarray(v) for v in fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feeds, fetch_list=fetch, scope=fluid.Scope())]


def test_adam_op_matches_reference():
    ps, gs, m1s, m2s, (b1p, b2p) = _state()
    for i in range(len(SHAPES)):
        feeds = {"p": ps[i], "g": gs[i], "m1": m1s[i], "m2": m2s[i],
                 "b1p": b1p, "b2p": b2p, "lr": np.array([LR], "float32")}
        args = ("adam", {"Param": ["p"], "Grad": ["g"], "Moment1": ["m1"],
                         "Moment2": ["m2"], "Beta1Pow": ["b1p"],
                         "Beta2Pow": ["b2p"], "LearningRate": ["lr"]},
                {"ParamOut": ["p"], "Moment1Out": ["m1"],
                 "Moment2Out": ["m2"]}, feeds)
        for g, w in zip(_run(tfluid, *args), _run(jfluid, *args)):
            np.testing.assert_allclose(g, w, **TOL)


def _fused_args(ps, gs, m1s, m2s, b1p, b2p):
    n = len(ps)
    names = {k: [f"{k}{i}" for i in range(n)] for k in ("p", "g", "ma", "mb")}
    feeds = {"b1p": b1p, "b2p": b2p, "lr": np.array([LR], "float32")}
    for k, vals in zip(("p", "g", "ma", "mb"), (ps, gs, m1s, m2s)):
        feeds.update(zip(names[k], vals))
    return ("fused_adam",
            {"Params": names["p"], "Grads": names["g"],
             "Moment1s": names["ma"], "Moment2s": names["mb"],
             "Beta1Pow": ["b1p"], "Beta2Pow": ["b2p"],
             "LearningRate": ["lr"]},
            {"ParamsOut": names["p"], "Moment1sOut": names["ma"],
             "Moment2sOut": names["mb"]}, feeds)


@pytest.mark.parametrize("routes", [("torch", "jnp"), ("cuda", "pallas")])
def test_fused_adam_matches_reference(routes):
    """The port's plain route against the reference's jnp twin, and its
    kernel route (the arena wrapper's plain version here) against the
    reference's arena kernel in interpret mode."""
    tfluid.set_flags({"kernel_tier": routes[0]})
    jfluid.set_flags({"kernel_tier": routes[1]})
    ps, gs, m1s, m2s, (b1p, b2p) = _state(1)
    args = _fused_args(ps, gs, m1s, m2s, b1p, b2p)
    got, want = _run(tfluid, *args), _run(jfluid, *args)
    assert len(got) == 3 * len(SHAPES)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_arena_plain_version_matches_pallas_kernel():
    ps, gs, m1s, m2s, (b1p, b2p) = _state(2)
    lr_eff = LR * np.sqrt(1 - b2p[0]) / (1 - b1p[0])
    arenas = [jax_opk.flatten_arena([jnp.asarray(a) for a in xs])[0]
              for xs in (ps, gs, m1s, m2s)]
    outs = jax_opk.adam_arena_pallas(*arenas, jnp.float32(lr_eff), B1, B2,
                                     EPS)
    want = [jax_opk.split_arena(o, SHAPES) for o in outs]
    t = lambda xs: [torch.from_numpy(a.copy()) for a in xs]  # noqa: E731
    got = opk.adam_arena(t(ps), t(gs), t(m1s), t(m2s),
                         torch.tensor(LR), torch.from_numpy(b1p),
                         torch.from_numpy(b2p), B1, B2, EPS)
    assert opk.launches["adam_arena"] == 0
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_arena_plain_version_is_the_per_parameter_expression():
    ps, gs, m1s, m2s, (b1p, b2p) = ([torch.from_numpy(a) for a in xs]
                                    for xs in _state(3))
    lr = torch.tensor(LR)
    got = opk.adam_arena_torch(ps, gs, m1s, m2s, lr, b1p, b2p, B1, B2, EPS)
    lr_eff = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    for i in range(len(SHAPES)):
        m1n = B1 * m1s[i] + (1 - B1) * gs[i]
        m2n = B2 * m2s[i] + (1 - B2) * gs[i] * gs[i]
        assert torch.equal(got[1][i], m1n) and torch.equal(got[2][i], m2n)
        assert torch.equal(got[0][i],
                           ps[i] - lr_eff * m1n / (torch.sqrt(m2n) + EPS))


@pytest.mark.parametrize("tier", ["torch", "cuda"])
def test_fused_and_per_parameter_adam_agree_bitwise(tier):
    """Adam(fused=True) and Adam(fused=False) train a small net to the same
    bits over 3 steps, on the plain route and on the kernel route (whose
    arena wrapper runs the per-parameter expression on CPU tensors)."""
    def run(fused):
        tfluid.reset_unique_name()
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 2
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[6])
            label = tfluid.layers.data("label", shape=[1], dtype="int64")
            prob = tfluid.layers.fc(tfluid.layers.fc(x, 8, act="relu"), 3,
                                    act="softmax")
            loss = tfluid.layers.mean(
                tfluid.layers.cross_entropy(prob, label))
            tfluid.optimizer.Adam(LR, fused=fused).minimize(loss, startup)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        feed = {"x": rng.normal(0, 1, (5, 6)).astype("float32"),
                "label": rng.randint(0, 3, (5, 1)).astype("int64")}
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        params = [p.name for p in main.global_block().all_parameters()]
        return {n: scope.find_var(n).numpy() for n in params}

    tfluid.set_flags({"kernel_tier": tier})
    per_param, fused = run(False), run(True)
    assert sorted(per_param) == sorted(fused)
    for name in per_param:
        np.testing.assert_array_equal(fused[name], per_param[name],
                                      err_msg=name)


def test_adam_programs_match_reference():
    """The optimizer appends the reference's ops with its accumulator names,
    fused and per parameter."""
    for fused in (False, True):
        progs = []
        for fluid in (jfluid, tfluid):
            fluid.framework.reset_unique_name()
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = fluid.layers.data("x", shape=[6])
                label = fluid.layers.data("label", shape=[1], dtype="int64")
                loss = fluid.layers.mean(fluid.layers.cross_entropy(
                    fluid.layers.fc(x, 3, act="softmax"), label))
                fluid.optimizer.Adam(LR, fused=fused).minimize(loss, startup)
            progs.append((main, startup))
        for jp, tp in zip(*progs):
            assert [op.type for op in tp.global_block().ops] == \
                [op.type for op in jp.global_block().ops]
            assert sorted(tp.global_block().vars) == \
                sorted(jp.global_block().vars)


def test_arena_wrapper_rejects_what_the_kernel_does_not_take():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would build and run")
    p = torch.empty((4,), device="meta")
    s = torch.empty((), device="meta")
    with pytest.raises(ValueError, match="non-empty"):
        opk.adam_arena([], [], [], [], s, s, s, B1, B2, EPS)
    with pytest.raises(ValueError, match="one-element float32"):
        opk.adam_arena([p], [p], [p], [p], s, s.half(), s, B1, B2, EPS)
    with pytest.raises(ValueError, match="contiguous float32"):
        opk.adam_arena([p], [p.half()], [p], [p], s, s, s, B1, B2, EPS)


@pytest.mark.cuda
def test_kernel_is_bitwise_the_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_adam.py on the GPU machine)")
    ps, gs, m1s, m2s, (b1p, b2p) = ([torch.from_numpy(a).cuda() for a in xs]
                                    for xs in _state(4))
    lr = torch.tensor(LR, device="cuda")
    want = opk.adam_arena_torch(ps, gs, m1s, m2s, lr, b1p, b2p, B1, B2, EPS)
    before = opk.launches["adam_arena"]
    got = opk.adam_arena([p.clone() for p in ps], gs,
                         [m.clone() for m in m1s], [m.clone() for m in m2s],
                         lr, b1p, b2p, B1, B2, EPS)
    torch.cuda.synchronize()
    assert opk.launches["adam_arena"] == before + 1
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            assert torch.equal(g, w)
