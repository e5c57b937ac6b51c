"""The port's momentum arena kernel module against the reference's.

``momentum_arena`` on CPU tensors runs its plain version,
``momentum_arena_torch``, the per-parameter expression. It is held against
the reference's ``momentum_arena_pallas`` run in interpret mode over
parameters of odd sizes (none a multiple of the reference's 1024-element
tile), with nesterov off and on. The kernel itself is checked bitwise
against the plain version where a card is present.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import optimizer as jax_opk
from paddle_tpu_torch.ops.cuda import optimizer as opk

SHAPES = [(3, 5), (1037,), (7, 3, 3, 2), (1,), (2049,)]
LR, MU = 0.05, 0.9
# both apply the same float32 multiply and add per element; XLA on the CPU
# may contract v·mu + g into one fused multiply-add, which rounds once
# instead of twice: one float32 step of the result
TOL = dict(rtol=2e-7, atol=1e-7)


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return [[rng.normal(0, 1, s).astype("float32") for s in SHAPES]
            for _ in range(3)]


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_arena_matches_pallas(nesterov):
    ps, gs, vs = _state()
    arenas = [jax_opk.flatten_arena([jnp.asarray(a) for a in xs])[0]
              for xs in (ps, gs, vs)]
    p_out, v_out = jax_opk.momentum_arena_pallas(*arenas, LR, MU,
                                                 nesterov=nesterov)
    want_p = jax_opk.split_arena(p_out, SHAPES)
    want_v = jax_opk.split_arena(v_out, SHAPES)
    t = [[torch.from_numpy(a.copy()) for a in xs] for xs in (ps, gs, vs)]
    got_p, got_v = opk.momentum_arena(*t, torch.tensor(LR), MU, nesterov)
    assert opk.launches["momentum_arena"] == 0
    for g, w in zip(got_p + got_v, want_p + want_v):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_plain_version_is_the_per_parameter_expression():
    """The plain version is bitwise the per-parameter momentum op's
    expression, which is what keeps a fused_momentum program bitwise equal
    to the per-parameter one under kernel_tier=torch."""
    ps, gs, vs = ([torch.from_numpy(a) for a in xs] for xs in _state(1))
    lr = torch.tensor(LR)
    got_p, got_v = opk.momentum_arena_torch(ps, gs, vs, lr, MU, True)
    for p, g, v, gp, gv in zip(ps, gs, vs, got_p, got_v):
        v_new = MU * v + g
        assert torch.equal(gv, v_new)
        assert torch.equal(gp, p - (g + MU * v_new) * lr)


def test_arena_wrapper_rejects_what_the_kernel_does_not_take():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would build and run")
    with pytest.raises(ValueError, match="non-empty"):
        opk.momentum_arena([], [], [], torch.tensor(LR), MU, False)
    p = torch.empty((4,), device="meta")
    g = torch.empty((4,), device="meta", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32"):
        opk.momentum_arena([p], [g], [p], torch.empty((), device="meta"),
                           MU, False)


@pytest.mark.cuda
@pytest.mark.parametrize("nesterov", [False, True])
def test_kernel_is_bitwise_the_plain_version_on_card(nesterov):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_optimizer_arena.py on the GPU machine)")
    ps, gs, vs = ([torch.from_numpy(a).cuda() for a in xs]
                  for xs in _state(2))
    lr = torch.tensor(LR, device="cuda")
    want_p, want_v = opk.momentum_arena_torch(ps, gs, vs, lr, MU, nesterov)
    before = opk.launches["momentum_arena"]
    got_p, got_v = opk.momentum_arena([p.clone() for p in ps], gs,
                                      [v.clone() for v in vs], lr, MU,
                                      nesterov)
    torch.cuda.synchronize()
    assert opk.launches["momentum_arena"] == before + 1
    for g, w in zip(got_p + got_v, want_p + want_v):
        assert torch.equal(g, w)


def test_fused_momentum_sends_the_float32_set_to_the_arena(monkeypatch):
    """Under a kernel tier fused_momentum hands its float32 parameters to
    the arena wrapper in one call and gives the rest the per-parameter
    expression; every result lands under its own parameter's name,
    bitwise the per-parameter expression."""
    import paddle_tpu_torch.fluid as tfluid
    seen = []
    real = opk.momentum_arena

    def spy(ps, *args):
        seen.append([tuple(p.shape) for p in ps])
        return real(ps, *args)

    monkeypatch.setattr(opk, "momentum_arena", spy)
    rng = np.random.RandomState(3)
    dtypes = ("float32", "float64", "float32")
    feeds = {"lr": np.array([LR], "float32")}
    for i, (shape, dtype) in enumerate(zip(SHAPES, dtypes)):
        for k in "pgv":
            feeds[f"{k}{i}"] = rng.normal(0, 1, shape).astype(dtype)
    prog = tfluid.Program()
    block = prog.global_block()
    for name, arr in feeds.items():
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
    ps, gs, vs = ([f"{k}{i}" for i in range(len(dtypes))] for k in "pgv")
    block.append_op("fused_momentum",
                    inputs={"Params": ps, "Grads": gs, "Velocities": vs,
                            "LearningRate": ["lr"]},
                    outputs={"ParamsOut": ps, "VelocitiesOut": vs},
                    attrs={"mu": MU, "use_nesterov": False})
    tfluid.set_flags({"kernel_tier": "cuda"})
    try:
        out = tfluid.Executor(tfluid.CPUPlace()).run(
            prog, feed=feeds, fetch_list=ps + vs, scope=tfluid.Scope())
    finally:
        tfluid.set_flags({"kernel_tier": "auto"})
    assert seen == [[SHAPES[0], SHAPES[2]]]
    lr = torch.tensor(LR).reshape(())
    for i in range(len(dtypes)):
        p, g, v = (torch.from_numpy(feeds[f"{k}{i}"]) for k in "pgv")
        want_p, want_v = opk._momentum_dense(p, g, v, lr, MU, False)
        assert out[i].dtype == np.dtype(dtypes[i])
        np.testing.assert_array_equal(out[i], want_p.numpy())
        np.testing.assert_array_equal(out[len(dtypes) + i], want_v.numpy())
