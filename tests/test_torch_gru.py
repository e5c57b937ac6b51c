"""The port's GRU against the reference's: the whole-sequence kernel
module's plain versions against the Pallas kernel and its custom vjp, and
the gru/gru_grad ops on both routes.

``gru_seq_torch`` and ``gru_seq_bwd_torch`` (what the kernel wrappers run
on CPU tensors) are held against ``jax.vjp`` of ``gru_seq_pallas``, run in
interpret mode, at b 3, L 7, H 16 with ragged lengths (one of them 0) and
a random h0. The ops run as a two-op program (gru, gru_grad) in each
package: the port's ``torch`` route against the reference's float32 scan
(``kernel_tier=jnp``), and its ``cuda`` route (the plain versions, on the
CPU) against the reference's Pallas kernel (``kernel_tier=pallas``), with
and without ``is_reverse``, with an H0 input. The kernels themselves are
held against the plain versions where a card is present.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import lod as jlod
from paddle_tpu.ops.pallas.rnn import gru_seq_pallas
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops import rnn_ops
from paddle_tpu_torch.ops.cuda import rnn

L, B, H = 7, 3, 16
LENS = np.array([7, 4, 0], np.int32)
# the reference's own kernel-vs-twin tolerances (tests/test_pallas_kernels.py
# :131-132, :145): float32 work in another order, and sigmoid/tanh that
# differ between XLA and PyTorch by a float32 step
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
# dw and dh0: each step's dW_t and the two products of the backward
# (dpre_c·W_cᵀ, [dpre_u|dpre_r]·W_urᵀ) are rounded to bfloat16 (the
# reference's vjp does so). A float32 step of difference upstream (the
# packages' sigmoid and tanh differ by that much) can carry an element
# across a bf16 rounding boundary, which moves it by one bf16 step, 2^-8 of
# its size; a moved dh then travels back through the earlier steps. So dw
# and dh0 are held to GRAD_TOL plus one such step of their largest
# pre-rounding term, and such elements must be rare. Measured over seeds
# 0-19: dw ≤ 1.6e-5 and dh0 ≤ 2.8e-4 of their largest element.
BF16_STEP = 2.0 ** -8
MAX_FLIPPED = 0.05


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _operands(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (L, B, 3 * H)).astype("float32")
    alive = (np.arange(L)[:, None] < LENS[None, :]) \
        .astype("float32")[..., None]
    w = rng.normal(0, 0.5, (H, 3 * H)).astype("float32")
    h0 = rng.normal(0, 1, (B, H)).astype("float32")
    dhs = rng.normal(0, 1, (L, B, H)).astype("float32") * alive
    return x, alive, w, h0, dhs


def _assert_flips(got, want, step, name):
    """got within GRAD_TOL but for bf16 rounding moves of at most ``step``
    (see BF16_STEP), which must be rare."""
    err = np.abs(got - want)
    np.testing.assert_array_less(
        err, GRAD_TOL["atol"] + step + GRAD_TOL["rtol"] * np.abs(want),
        err_msg=name)
    outside = err > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want)
    assert outside.mean() <= MAX_FLIPPED, (name, outside.mean())


def _bf16_steps(w, h_max, dx):
    """One bf16 step of the largest dW_t term (b · max|h| · max|dgates|)
    and of the largest dh product term (3H · max|w| · max|dgates|)."""
    g = np.abs(dx).max()
    return (BF16_STEP * dx.shape[-2] * h_max * g,
            BF16_STEP * dx.shape[-1] * np.abs(w).max() * g)


@pytest.mark.parametrize("seed", [0, 14])
def test_plain_versions_match_the_pallas_kernel_and_its_vjp(seed):
    x, alive, w, h0, dhs = _operands(seed)
    hs, vjp = jax.vjp(lambda x, w, h0: gru_seq_pallas(x, jnp.asarray(alive),
                                                      w, h0), x, w, h0)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dhs))]
    t = [torch.from_numpy(a) for a in (x, alive, w, h0)]
    ths = rnn.gru_seq_torch(*t)
    np.testing.assert_allclose(ths.numpy(), np.asarray(hs), **FWD_TOL)
    dx, dw, dh0 = (g.numpy() for g in rnn.gru_seq_bwd_torch(
        *t, ths, torch.from_numpy(dhs)))
    assert dx.shape == want[0].shape and dw.shape == w.shape
    np.testing.assert_allclose(dx, want[0], **GRAD_TOL, err_msg="dx")
    dw_step, dh_step = _bf16_steps(w, max(np.abs(h0).max(), 1.0), dx)
    _assert_flips(dw, want[1], dw_step, "dw")
    _assert_flips(dh0, want[2], dh_step, "dh0")


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    x, alive, w, h0, dhs = (torch.from_numpy(a) for a in _operands(1))
    rnn.reset_launches()
    hs = rnn.gru_seq(x, alive, w, h0)
    grads = rnn.gru_seq_bwd(x, alive, w, h0, hs, dhs)
    assert rnn.launches["gru_seq"] == rnn.launches["gru_seq_bwd"] == 0
    assert torch.equal(hs, rnn.gru_seq_torch(x, alive, w, h0))
    for g, w_ in zip(grads, rnn.gru_seq_bwd_torch(x, alive, w, h0, hs, dhs)):
        assert torch.equal(g, w_)


def test_gru_seq_autograd_function_replays_given_carries():
    """GruSeq with the carries of a forward that ran gives the same
    gradients as autograd through the plain forward's kernel pair, and
    the raw carries come back bitwise from the op's masked outputs."""
    x, alive, w, h0, dhs = (torch.from_numpy(a) for a in _operands(2))
    hs = rnn.gru_seq_torch(x, alive, w, h0)
    masked = (hs * alive).transpose(0, 1)
    raw = rnn_ops._raw_carries(masked, torch.from_numpy(LENS), h0)
    assert torch.equal(raw, hs)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, h0)]
    out = rnn.GruSeq.apply(leaves[0], alive, leaves[1], leaves[2], raw)
    got = torch.autograd.grad(out, leaves, dhs)
    want = rnn.gru_seq_bwd_torch(x, alive, w, h0, hs, dhs)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def _gru_program(fluid, is_reverse, feeds):
    """gru then gru_grad over the feeds; fetches the output and every
    gradient."""
    prog = fluid.Program()
    block = prog.global_block()
    for name, v in feeds.items():
        lod = isinstance(v, (jlod.LoDArray, tlod.LoDArray))
        arr = v.data if lod else v
        block.create_var(name=name, shape=tuple(arr.shape),
                         dtype="float32", lod_level=int(lod))
    grads = {"Input@GRAD": ["dx"], "Weight@GRAD": ["dw"],
             "Bias@GRAD": ["db"], "H0@GRAD": ["dh0"]}
    for n in ["hidden"] + [v[0] for v in grads.values()]:
        block.create_var(name=n)
    ins = {"Input": ["x"], "Weight": ["w"], "Bias": ["b"], "H0": ["h0"]}
    attrs = {"is_reverse": is_reverse, "gate_activation": "sigmoid",
             "activation": "tanh"}
    block.append_op("gru", inputs=ins, outputs={"Hidden": ["hidden"]},
                    attrs=attrs)
    grad_ins = dict(ins, **{"Hidden@GRAD": ["dhid"]})
    if fluid is tfluid:
        grad_ins["Hidden"] = ["hidden"]
    block.append_op("gru_grad", inputs=grad_ins, outputs=grads, attrs=attrs)
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feeds, fetch_list=["hidden"]
        + [v[0] for v in grads.values()], scope=fluid.Scope())
    return [np.asarray(v.data) if hasattr(v, "lens") else np.asarray(v)
            for v in out]


@pytest.mark.parametrize("is_reverse", [False, True])
@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_gru_ops_match_reference(route, is_reverse):
    """The port's torch route against the reference's float32 scan, and its
    cuda route (the kernel wrappers' plain versions here) against the
    reference's Pallas kernel in interpret mode."""
    rng = np.random.RandomState(3)
    mask = (np.arange(L)[None, :] < LENS[:, None])[..., None]
    x = (rng.normal(0, 1, (B, L, 3 * H)) * mask).astype("float32")
    dense = {"w": rng.normal(0, 0.5, (H, 3 * H)).astype("float32"),
             "b": rng.normal(0, 0.1, (1, 3 * H)).astype("float32"),
             "h0": rng.normal(0, 1, (B, H)).astype("float32")}
    dhid = (rng.normal(0, 1, (B, L, H)) * mask).astype("float32")
    jfluid.set_flags({"kernel_tier": {"torch": "jnp",
                                      "cuda": "pallas"}[route]})
    tfluid.set_flags({"kernel_tier": route})
    want = _gru_program(jfluid, is_reverse, dict(
        dense, x=jlod.LoDArray(x, LENS), dhid=jlod.LoDArray(dhid, LENS)))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    ttier.reset_fallback_counts()
    got = _gru_program(tfluid, is_reverse, dict(
        dense, x=tlod.LoDArray(t(x), t(LENS)),
        dhid=tlod.LoDArray(t(dhid), t(LENS))))
    assert ttier.fallback_counts() == {}
    names = ["hidden", "dx", "dw", "db", "dh0"]
    dx_seq = got[1].transpose(1, 0, 2)
    dw_step, dh_step = _bf16_steps(dense["w"],
                                   max(np.abs(dense["h0"]).max(), 1.0),
                                   dx_seq)
    for name, g, w_ in zip(names, got, want):
        assert g.shape == w_.shape, (name, g.shape, w_.shape)
        if route == "cuda" and name in ("dw", "dh0"):
            _assert_flips(g, w_, dw_step if name == "dw" else dh_step, name)
        else:
            np.testing.assert_allclose(
                g, w_, **(FWD_TOL if name == "hidden" else GRAD_TOL),
                err_msg=name)


def test_unsupported_gru_routes_to_the_scan_and_is_counted():
    """A relu candidate is outside the kernel: under kernel_tier=cuda the
    op takes the float32 scan and the fallback is counted."""
    rng = np.random.RandomState(4)
    prog = tfluid.Program()
    block = prog.global_block()
    feeds = {"x": rng.normal(0, 1, (B, L, 3 * H)).astype("float32"),
             "w": rng.normal(0, 0.5, (H, 3 * H)).astype("float32")}
    for name, v in feeds.items():
        block.create_var(name=name, shape=v.shape, dtype="float32")
    block.create_var(name="hidden")
    block.append_op("gru", inputs={"Input": ["x"], "Weight": ["w"]},
                    outputs={"Hidden": ["hidden"]},
                    attrs={"activation": "relu"})
    tfluid.set_flags({"kernel_tier": "cuda"})
    ttier.reset_fallback_counts()
    hidden, = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feeds, fetch_list=["hidden"], scope=tfluid.Scope())
    assert ttier.fallback_counts() == {"gru": 1}
    assert hidden.data.shape == (B, L, H) and np.isfinite(hidden.data).all()


def test_wrappers_reject_what_the_kernels_do_not_take():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would build and run")
    x = torch.empty((L, B, 3 * H), device="meta")
    alive = torch.empty((L, B, 1), device="meta")
    w = torch.empty((H, 3 * H), device="meta")
    h = torch.empty((B, H), device="meta")
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        rnn.gru_seq(x.half(), alive, w, h)
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        rnn.gru_seq(x, alive, torch.empty((H, 4 * H), device="meta"), h)
    with pytest.raises(ValueError, match="contiguous float32"):
        rnn.gru_seq(x, alive, w.T.contiguous().T, h)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 3, 16), (20, 64, 512)])
def test_kernels_match_the_plain_versions_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_gru.py on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    steps, b, hdim = shape
    rng = np.random.RandomState(5)
    lens = rng.randint(0, steps + 1, b)
    lens[0] = steps
    alive = (np.arange(steps)[:, None] < lens[None, :]) \
        .astype("float32")[..., None]
    arrs = [rng.normal(0, 1, (steps, b, 3 * hdim)), alive,
            rng.normal(0, 0.05, (hdim, 3 * hdim)), rng.normal(0, 1, (b, hdim)),
            rng.normal(0, 1, (steps, b, hdim)) * alive]
    x, alive, w, h0, dhs = (torch.tensor(a, dtype=torch.float32,
                                         device="cuda") for a in arrs)
    rnn.reset_launches()
    hs = rnn.gru_seq(x, alive, w, h0)
    grads = rnn.gru_seq_bwd(x, alive, w, h0, hs, dhs)
    torch.cuda.synchronize()
    assert (rnn.launches["gru_seq"], rnn.launches["gru_seq_bwd"]) == (1, 1)
    # the limits chip_smoke.py phase 7 states with their reasons: the two
    # versions sum in other float32 orders, and the bf16 roundings inside
    # each step (of h, of r ⊙ h, and four in the backward) turn a float32
    # step of difference into a bf16 step now and then
    for g, w_, l2 in ((hs, rnn.gru_seq_torch(x, alive, w, h0), 2e-3),) + \
            tuple((g, w_, 4e-3) for g, w_ in zip(
                grads, rnn.gru_seq_bwd_torch(x, alive, w, h0, hs, dhs))):
        d = g - w_
        assert (d.abs().max() / w_.abs().max()).item() <= 1e-2
        assert (d.norm() / w_.norm()).item() <= l2
