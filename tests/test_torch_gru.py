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


def _tc_product(a_parts, w_parts):
    """sum_i a_i . w_iᵀ ([b, K_i] . [H, K_i]ᵀ) as csrc/seq_mma.cuh's chain
    sums it: each 16-column k-step one tensor-core sum of exact products
    (here float64, rounded to float32 once), each of the 8 warps adding
    its k-steps w, w + 8, ... of every part in turn in float32, then the
    warps' sums added in warp order."""
    terms = []
    for a, w in zip(a_parts, w_parts):
        steps = a.shape[-1] // 16
        terms.append((a.double().reshape(a.shape[0], 1, steps, 16)
                      * w.double().reshape(1, w.shape[0], steps, 16))
                     .sum(-1).float())
    total = None
    for warp in range(8):
        acc = torch.zeros(terms[0].shape[:2])
        for t in terms:
            for step in range(warp, t.shape[-1], 8):
                acc = acc + t[..., step]
        total = acc if total is None else total + acc
    return total


def _dw_steps(a, d):
    """sum over t descending of bf16(a_tᵀ . d_t), each a fresh
    tensor-core sum over the batch (float64 here, rounded to float32)."""
    dw = torch.zeros(a.shape[-1], d.shape[-1])
    for t in reversed(range(a.shape[0])):
        dw = dw + rnn._bf16((a[t].double().T @ d[t].double()).float())
    return dw


def _kernel_model_bwd(x, alive, w, h0, hs, dhs):
    """csrc/gru_seq.cu's backward, decomposed as the kernel decomposes it,
    in plain torch: the prologue's u and r of every step in one GEMM, then
    bf16(r ⊙ h_{t-1}) and c in a second; the chain's cell math
    (gru_seq_bwd_torch's operation order) with cd and the dh product
    summed as _tc_product sums them (dpre_u's k-steps before dpre_r's);
    the epilogue's dW in _dw_steps' order."""
    steps, b, h3 = x.shape
    hdim = h3 // 3
    wb = rnn._bf16(w)
    h_prevs = torch.cat([h0[None], hs[:-1]])
    hb = rnn._bf16(h_prevs)
    ur = x[..., :2 * hdim] + (hb.reshape(-1, hdim) @ wb[:, :2 * hdim]) \
        .reshape(steps, b, 2 * hdim)
    us, rs = torch.sigmoid(ur).split(hdim, -1)
    rh = rnn._bf16(rs * h_prevs)
    cs = torch.tanh(x[..., 2 * hdim:] + (rh.reshape(-1, hdim)
                                         @ wb[:, 2 * hdim:]).reshape(
                                             steps, b, hdim))
    w_u, w_r, w_c = (wb[:, k * hdim:(k + 1) * hdim] for k in range(3))
    dh = torch.zeros_like(h0)
    dx = torch.empty_like(x)
    for t in reversed(range(steps)):
        a, hp, u, r, c = alive[t], h_prevs[t], us[t], rs[t], cs[t]
        e = dh + dhs[t]
        bl = a * e
        bn = (1 - a) * e + (1 - u) * bl
        du = bl * c - bl * hp
        bt = (u * bl) * (1 - c)
        dpc = bt + bt * c
        cd = rnn._bf16(_tc_product([dpc], [w_c]))
        dpr = (cd * hp) * (r * (1 - r))
        dpu = du * (u * (1 - u))
        dx[t] = torch.cat([dpu, dpr, dpc], dim=-1)
        dh = (bn + r * cd) + rnn._bf16(_tc_product([dpu, dpr], [w_u, w_r]))
    dw = torch.cat([_dw_steps(hb, dx[..., :2 * hdim]),
                    _dw_steps(rh, dx[..., 2 * hdim:])], dim=-1)
    return dx, dw, dh


@pytest.mark.parametrize("seed", [0, 14])
def test_kernel_decomposition_matches_the_reference_vjp(seed):
    """The backward kernel's summation structure (prologue GEMMs, chain
    sums by k-step and warp, per-step bf16 dW in t-descending order) stays
    within the tolerances the plain version is held to against the
    reference's custom vjp (_gru_seq_bwd)."""
    x, alive, w, h0, dhs = _operands(seed)
    hs, vjp = jax.vjp(lambda x, w, h0: gru_seq_pallas(x, jnp.asarray(alive),
                                                      w, h0), x, w, h0)
    want = [np.asarray(g) for g in vjp(jnp.asarray(dhs))]
    t = [torch.from_numpy(a) for a in (x, alive, w, h0)]
    dx, dw, dh0 = (g.numpy() for g in _kernel_model_bwd(
        *t, torch.from_numpy(np.array(hs)), torch.from_numpy(dhs)))
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


# (L, b, H) on the card: the first two, then the backward's hard cases: one
# step; one batch row and 33 (not a multiple of the 8- or 16-row groups of
# the chain or of the mma tiles); H 80 and 208 (not multiples of 32: 16
# units a chain block, grids of 20 and 52 blocks); the CTC model's 200
# frames at the lane's widths
CARD_SHAPES = [(7, 3, 16), (20, 64, 512), (1, 64, 512), (20, 1, 512),
               (20, 33, 512), (20, 64, 80), (20, 33, 208), (200, 64, 512)]


def _card_operands(steps, b, hdim, seed=5):
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, steps + 1, b)
    lens[0] = steps
    alive = (np.arange(steps)[:, None] < lens[None, :]) \
        .astype("float32")[..., None]
    arrs = [rng.normal(0, 1, (steps, b, 3 * hdim)), alive,
            rng.normal(0, 0.05, (hdim, 3 * hdim)), rng.normal(0, 1, (b, hdim)),
            rng.normal(0, 1, (steps, b, hdim)) * alive]
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrs]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_gru.py on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_the_plain_versions_on_card(shape):
    _need_card()
    x, alive, w, h0, dhs = _card_operands(*shape)
    rnn.reset_launches()
    hs = rnn.gru_seq(x, alive, w, h0)
    grads = rnn.gru_seq_bwd(x, alive, w, h0, hs, dhs)
    again = rnn.gru_seq_bwd(x, alive, w, h0, hs, dhs)
    torch.cuda.synchronize()
    assert (rnn.launches["gru_seq"], rnn.launches["gru_seq_bwd"]) == (1, 2)
    # the limits chip_smoke.py phase 7 states with their reasons: the two
    # versions sum in other float32 orders, and the bf16 roundings inside
    # each step (of h, of r ⊙ h, and four in the backward) turn a float32
    # step of difference into a bf16 step now and then; the backward is
    # bitwise the same on a second launch
    for g, g2, w_, l2 in ((hs, hs, rnn.gru_seq_torch(x, alive, w, h0),
                           2e-3),) + \
            tuple((g, g2, w_, 4e-3) for g, g2, w_ in zip(
                grads, again,
                rnn.gru_seq_bwd_torch(x, alive, w, h0, hs, dhs))):
        assert torch.equal(g, g2)
        d = g - w_
        assert (d.abs().max() / w_.abs().max()).item() <= 1e-2
        assert (d.norm() / w_.norm()).item() <= l2


def _planted(t, where, bits):
    """A copy of float32 ``t`` with the bit patterns ``bits`` at the
    indices ``where`` (set through an int32 view on the CPU, so that no
    conversion on the card replaces a NaN's payload)."""
    c = t.cpu().clone()
    for idx, v in zip(where, bits):
        c.view(torch.int32)[idx] = v
    return c.to(t.device)


def _bits(v):
    return int(np.array(v, np.float32).view(np.int32))


# NaN (the card's 0x7fffffff, its negative, and 0x7f800001, whose payload
# lies only in the low 16 bits), ±Inf and ±3.4e38 planted in the carry's
# cotangent: all at the first step, whose dpre reach dx_0, dh0 and the dW
# columns of their units only, and a NaN and -Inf at later steps, which
# spread through every earlier step of their rows
NAN_PLANTS = {
    "first": [((0, 1, 3), 0x7FFFFFFF), ((0, 2, 40), -1),
              ((0, 4, 100), 0x7F800001), ((0, 5, 7), 0x7F800000),
              ((0, 6, 9), _bits(-np.inf)), ((0, 8, 200), _bits(3.4e38)),
              ((0, 9, 300), _bits(-3.4e38))],
    "later": [((19, 0, 11), 0x7F800001), ((10, 3, 50), _bits(-np.inf))],
}


@pytest.mark.cuda
@pytest.mark.parametrize("plants", sorted(NAN_PLANTS))
def test_seq_bwd_propagate_nan_and_inf_on_card(plants):
    """NaN and ±Inf in dhs reach dx, dw and dh0 where they reach
    gru_seq_bwd_torch's: NaN at the same positions, the same infinities;
    the finite rest within the card test's 1e-2. The kernel's products
    split each float32 dpre into three bf16 parts, which must carry an
    infinity and a NaN whole."""
    _need_card()
    x, alive, w, h0, dhs = _card_operands(20, 16, 512, seed=6)
    alive = torch.ones_like(alive)
    dhs = _planted(dhs, [p for p, _ in NAN_PLANTS[plants]],
                   [v for _, v in NAN_PLANTS[plants]])
    hs = rnn.gru_seq_torch(x, alive, w, h0)
    got = rnn.gru_seq_bwd(x, alive, w, h0, hs, dhs)
    want = rnn.gru_seq_bwd_torch(x, alive, w, h0, hs, dhs)
    torch.cuda.synchronize()
    for name, g, w_ in zip(("dx", "dw", "dh0"), got, want):
        nan = torch.isnan(w_)
        assert torch.equal(torch.isnan(g), nan), name
        inf = torch.isinf(w_)
        assert torch.equal(torch.isinf(g), inf), name
        assert torch.equal(g[inf], w_[inf]), name
        fin = ~(nan | inf)
        if fin.any():   # a NaN at a later step reaches every dW element
            d = (g[fin] - w_[fin]).abs().max() / w_[fin].abs().max()
            assert d.item() <= 1e-2, name
    assert bool(torch.isfinite(got[1]).any()) == (plants == "first")
