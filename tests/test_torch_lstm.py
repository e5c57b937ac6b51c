"""The port's LSTM against the reference's: the whole-sequence kernel
module's plain versions against the Pallas kernel and its custom vjp, and
the lstm/lstm_grad ops on both routes.

``lstm_seq_torch`` and ``lstm_seq_bwd_torch`` (what the kernel wrappers run
on CPU tensors) are held against ``jax.vjp`` of ``lstm_seq_pallas``, run in
interpret mode, at b 3, L 7, H 16 with ragged lengths (one of them 0) and
random h0, c0. The ops run as a two-op program (lstm, lstm_grad) in each
package: the port's ``torch`` route against the reference's float32 scan
(``kernel_tier=jnp``), and its ``cuda`` route (the plain versions, on the
CPU) against the reference's Pallas kernel (``kernel_tier=pallas``), with
and without ``is_reverse``, with H0 and C0 inputs. The kernels themselves
are held against the plain versions where a card is present.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import lod as jlod
from paddle_tpu.ops.pallas.rnn import lstm_seq_pallas
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
# dw: each step's dW_t is rounded to bfloat16 before it is summed (the
# reference's vjp does so). A float32 step of difference in dgates (the
# packages' sigmoid and tanh differ by that much) can carry a dW_t element
# across a bf16 rounding boundary, which moves it by one bf16 step, 2^-8 of
# its size. So dw is held to GRAD_TOL plus one such step of the largest
# dW_t, bounded by b · max|h| · max|dgates|; and such elements must be rare.
BF16_STEP = 2.0 ** -8
MAX_FLIPPED = 0.02


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _operands(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (L, B, 4 * H)).astype("float32")
    alive = (np.arange(L)[:, None] < LENS[None, :]) \
        .astype("float32")[..., None]
    w = rng.normal(0, 0.5, (H, 4 * H)).astype("float32")
    h0 = rng.normal(0, 1, (B, H)).astype("float32")
    c0 = rng.normal(0, 1, (B, H)).astype("float32")
    dhs = rng.normal(0, 1, (L, B, H)).astype("float32") * alive
    dcs = rng.normal(0, 1, (L, B, H)).astype("float32") * alive
    return x, alive, w, h0, c0, dhs, dcs


def _assert_dw(got, want, h_max, dgates, name="dw"):
    """dw within GRAD_TOL but for bf16 rounding flips (see BF16_STEP)."""
    step = BF16_STEP * dgates.shape[-2] * h_max * np.abs(dgates).max()
    err = np.abs(got - want)
    np.testing.assert_array_less(
        err, GRAD_TOL["atol"] + step + GRAD_TOL["rtol"] * np.abs(want),
        err_msg=name)
    outside = err > GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(want)
    assert outside.mean() <= MAX_FLIPPED, (name, outside.mean())


def test_plain_versions_match_the_pallas_kernel_and_its_vjp():
    x, alive, w, h0, c0, dhs, dcs = _operands()
    (hs, cs), vjp = jax.vjp(
        lambda x, w, h0, c0: lstm_seq_pallas(x, jnp.asarray(alive), w, h0,
                                             c0), x, w, h0, c0)
    want = [np.asarray(g) for g in vjp((jnp.asarray(dhs),
                                        jnp.asarray(dcs)))]
    t = [torch.from_numpy(a) for a in (x, alive, w, h0, c0)]
    ths, tcs = rnn.lstm_seq_torch(*t)
    np.testing.assert_allclose(ths.numpy(), np.asarray(hs), **FWD_TOL)
    np.testing.assert_allclose(tcs.numpy(), np.asarray(cs), **FWD_TOL)
    got = [g.numpy() for g in rnn.lstm_seq_bwd_torch(
        *t, ths, tcs, torch.from_numpy(dhs), torch.from_numpy(dcs))]
    for name, g, w_ in zip(("dx", "dh0", "dc0"), got[:1] + got[2:],
                           want[:1] + want[2:]):
        assert g.shape == w_.shape
        np.testing.assert_allclose(g, w_, **GRAD_TOL, err_msg=name)
    _assert_dw(got[1], want[1], max(np.abs(h0).max(), 1.0), got[0])


def _fwd_product(a, w):
    """a [b, K] . w [K, N] as csrc/lstm_seq.cu's forward sums it (the gate
    tiles of csrc/seq_mma.cuh): each 16-deep k-step one tensor-core sum of
    exact bf16 x bf16 products (here float64, rounded to float32 once), the
    k-steps added in increasing k in float32."""
    steps = a.shape[-1] // 16
    parts = (a.double().reshape(a.shape[0], steps, 16, 1)
             * w.double().reshape(1, steps, 16, w.shape[-1])).sum(2).float()
    total = torch.zeros(a.shape[0], w.shape[-1])
    for s in range(steps):
        total = total + parts[:, s]
    return total


def _kernel_model_fwd(x, alive, w, h0, c0):
    """csrc/lstm_seq.cu's forward, decomposed as the kernel sums it, in
    plain torch: each step's gate product by _fwd_product, x_t added after
    it, then the reference's cell (lstm_seq_torch's operation order)."""
    wb = rnn._bf16(w)
    h, c = h0, c0
    hs, cs = [], []
    for t in range(x.shape[0]):
        h, c = rnn._cell(x[t] + _fwd_product(rnn._bf16(h), wb), c, h,
                         alive[t])
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_kernel_decomposition_matches_the_pallas_kernel(seed):
    """The forward kernel's summation order (a fresh tensor-core sum per
    16-deep k-step, the k-steps added in increasing k, x_t added after the
    product) stays within the tolerance the plain version is held to
    against the reference's Pallas kernel."""
    x, alive, w, h0, c0, _, _ = _operands(seed)
    hs, cs = lstm_seq_pallas(x, jnp.asarray(alive), w, h0, c0)
    got = _kernel_model_fwd(*(torch.from_numpy(a)
                              for a in (x, alive, w, h0, c0)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(hs), **FWD_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(cs), **FWD_TOL)


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


def _kernel_model_bwd(x, alive, w, h0, c0, hs, cs, dhs, dcs):
    """csrc/lstm_seq.cu's backward, decomposed as the kernel decomposes
    it, in plain torch: the prologue's gates of every step in one GEMM,
    the chain's cell math (lstm_seq_bwd_torch's operation order) with the
    dh product summed as _tc_product sums it, and the epilogue's dW in
    _dw_steps' order."""
    steps, b, h4 = x.shape
    hdim = h4 // 4
    wb = rnn._bf16(w)
    hb = rnn._bf16(torch.cat([h0[None], hs[:-1]]))
    c_prevs = torch.cat([c0[None], cs[:-1]])
    g = x + (hb.reshape(-1, hdim) @ wb).reshape(steps, b, h4)
    act = torch.cat([torch.sigmoid(g[..., :2 * hdim]),
                     torch.tanh(g[..., 2 * hdim:3 * hdim]),
                     torch.sigmoid(g[..., 3 * hdim:])], -1)
    dh, dc = torch.zeros_like(h0), torch.zeros_like(c0)
    dx = torch.empty_like(x)
    for t in reversed(range(steps)):
        i, f, u, o = act[t].split(hdim, -1)
        a, cp = alive[t], c_prevs[t]
        tc = torch.tanh(f * cp + i * u)
        dh_t, dc_t = dh + dhs[t], dc + dcs[t]
        bp = a * dh_t
        bs = (o * bp) * (1 - tc)
        dcn = (a * dc_t + bs) + bs * tc
        d_cand = (i * dcn) * (1 - u)
        dx[t] = torch.cat([(dcn * u) * (i * (1 - i)),
                           (dcn * cp) * (f * (1 - f)),
                           d_cand + d_cand * u,
                           (bp * tc) * (o * (1 - o))], dim=-1)
        dh = (1 - a) * dh_t + rnn._bf16(_tc_product([dx[t]], [wb]))
        dc = (1 - a) * dc_t + f * dcn
    return dx, _dw_steps(hb, dx), dh, dc


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_decomposition_matches_the_reference_vjp(seed):
    """The backward kernel's summation structure (prologue GEMM, chain
    sums by k-step and warp, per-step bf16 dW in t-descending order) stays
    within the tolerances the plain version is held to against the
    reference's custom vjp (_lstm_seq_bwd)."""
    x, alive, w, h0, c0, dhs, dcs = _operands(seed)
    (hs, cs), vjp = jax.vjp(
        lambda x, w, h0, c0: lstm_seq_pallas(x, jnp.asarray(alive), w, h0,
                                             c0), x, w, h0, c0)
    want = [np.asarray(g) for g in vjp((jnp.asarray(dhs),
                                        jnp.asarray(dcs)))]
    t = [torch.from_numpy(a) for a in (x, alive, w, h0, c0)]
    got = [g.numpy() for g in _kernel_model_bwd(
        *t, torch.from_numpy(np.array(hs)), torch.from_numpy(np.array(cs)),
        torch.from_numpy(dhs), torch.from_numpy(dcs))]
    for name, g, w_ in zip(("dx", "dh0", "dc0"), got[:1] + got[2:],
                           want[:1] + want[2:]):
        np.testing.assert_allclose(g, w_, **GRAD_TOL, err_msg=name)
    _assert_dw(got[1], want[1], max(np.abs(h0).max(), 1.0), got[0])


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    x, alive, w, h0, c0, dhs, dcs = (torch.from_numpy(a)
                                     for a in _operands(1))
    rnn.reset_launches()
    hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
    grads = rnn.lstm_seq_bwd(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    assert rnn.launches["lstm_seq"] == rnn.launches["lstm_seq_bwd"] == 0
    want_hs, want_cs = rnn.lstm_seq_torch(x, alive, w, h0, c0)
    assert torch.equal(hs, want_hs) and torch.equal(cs, want_cs)
    for g, w_ in zip(grads, rnn.lstm_seq_bwd_torch(x, alive, w, h0, c0, hs,
                                                   cs, dhs, dcs)):
        assert torch.equal(g, w_)


def test_raw_carries_are_rebuilt_exactly_from_masked_outputs():
    """The grad op's replay: an op's outputs (carries × alive) give back the
    forward's carries bitwise, frozen after each row's length and h0
    throughout a row of length 0."""
    x, alive, w, h0, c0, _, _ = (torch.from_numpy(a) for a in _operands(2))
    hs, _ = rnn.lstm_seq_torch(x, alive, w, h0, c0)
    masked = (hs * alive).transpose(0, 1)
    assert torch.equal(rnn_ops._raw_carries(masked, torch.from_numpy(LENS),
                                            h0), hs)


def _lstm_program(fluid, is_reverse, feeds):
    """lstm then lstm_grad over the feeds; fetches the outputs and every
    gradient."""
    prog = fluid.Program()
    block = prog.global_block()
    for name, v in feeds.items():
        lod = isinstance(v, (jlod.LoDArray, tlod.LoDArray))
        arr = v.data if lod else v
        block.create_var(name=name, shape=tuple(arr.shape),
                         dtype="float32", lod_level=int(lod))
    fwd_out = {"Hidden": ["hidden"], "Cell": ["cell"]}
    grads = {"Input@GRAD": ["dx"], "Weight@GRAD": ["dw"],
             "Bias@GRAD": ["db"], "H0@GRAD": ["dh0"], "C0@GRAD": ["dc0"]}
    for n in ["hidden", "cell"] + [v[0] for v in grads.values()]:
        block.create_var(name=n)
    ins = {"Input": ["x"], "Weight": ["w"], "Bias": ["b"], "H0": ["h0"],
           "C0": ["c0"]}
    attrs = {"use_peepholes": False, "is_reverse": is_reverse,
             "gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "tanh"}
    block.append_op("lstm", inputs=ins, outputs=fwd_out, attrs=attrs)
    block.append_op("lstm_grad", inputs=dict(
        ins, Hidden=["hidden"], Cell=["cell"], **{"Hidden@GRAD": ["dhid"],
                                                  "Cell@GRAD": ["dcell"]}),
        outputs=grads, attrs=attrs)
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feeds, fetch_list=["hidden", "cell"]
        + [v[0] for v in grads.values()], scope=fluid.Scope())
    return [np.asarray(v.data) if hasattr(v, "lens") else np.asarray(v)
            for v in out]


@pytest.mark.parametrize("is_reverse", [False, True])
@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_lstm_ops_match_reference(route, is_reverse):
    """The port's torch route against the reference's float32 scan, and its
    cuda route (the kernel wrappers' plain versions here) against the
    reference's Pallas kernel in interpret mode."""
    rng = np.random.RandomState(3)
    lens = LENS
    mask = (np.arange(L)[None, :] < lens[:, None])[..., None]
    x = (rng.normal(0, 1, (B, L, 4 * H)) * mask).astype("float32")
    dense = {"w": rng.normal(0, 0.5, (H, 4 * H)).astype("float32"),
             "b": rng.normal(0, 0.1, (1, 4 * H)).astype("float32"),
             "h0": rng.normal(0, 1, (B, H)).astype("float32"),
             "c0": rng.normal(0, 1, (B, H)).astype("float32")}
    dhid = (rng.normal(0, 1, (B, L, H)) * mask).astype("float32")
    dcell = (rng.normal(0, 1, (B, L, H)) * mask).astype("float32")
    jfluid.set_flags({"kernel_tier": {"torch": "jnp",
                                      "cuda": "pallas"}[route]})
    tfluid.set_flags({"kernel_tier": route})
    want = _lstm_program(jfluid, is_reverse, dict(
        dense, x=jlod.LoDArray(x, lens), dhid=jlod.LoDArray(dhid, lens),
        dcell=jlod.LoDArray(dcell, lens)))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    ttier.reset_fallback_counts()
    got = _lstm_program(tfluid, is_reverse, dict(
        dense, x=tlod.LoDArray(t(x), t(lens)),
        dhid=tlod.LoDArray(t(dhid), t(lens)),
        dcell=tlod.LoDArray(t(dcell), t(lens))))
    assert ttier.fallback_counts() == {}
    names = ["hidden", "cell", "dx", "dw", "db", "dh0", "dc0"]
    for name, g, w_ in zip(names, got, want):
        assert g.shape == w_.shape, (name, g.shape, w_.shape)
        if name == "dw" and route == "cuda":
            _assert_dw(g, w_, max(np.abs(dense["h0"]).max(), 1.0), got[2])
        else:
            np.testing.assert_allclose(
                g, w_, **(FWD_TOL if name in ("hidden", "cell")
                          else GRAD_TOL), err_msg=name)


def test_unsupported_lstm_routes_to_the_scan_and_is_counted():
    """Peepholes are outside the kernel: under kernel_tier=cuda the op
    takes the float32 scan and the fallback is counted."""
    rng = np.random.RandomState(4)
    prog = tfluid.Program()
    block = prog.global_block()
    feeds = {"x": rng.normal(0, 1, (B, L, 4 * H)).astype("float32"),
             "w": rng.normal(0, 0.5, (H, 4 * H)).astype("float32"),
             "b": rng.normal(0, 0.1, (1, 7 * H)).astype("float32")}
    for name, v in feeds.items():
        block.create_var(name=name, shape=v.shape, dtype="float32")
    for n in ("hidden", "cell"):
        block.create_var(name=n)
    block.append_op("lstm", inputs={"Input": ["x"], "Weight": ["w"],
                                    "Bias": ["b"]},
                    outputs={"Hidden": ["hidden"], "Cell": ["cell"]},
                    attrs={"use_peepholes": True})
    tfluid.set_flags({"kernel_tier": "cuda"})
    ttier.reset_fallback_counts()
    hidden, = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feeds, fetch_list=["hidden"], scope=tfluid.Scope())
    assert ttier.fallback_counts() == {"lstm": 1}
    assert hidden.data.shape == (B, L, H) and np.isfinite(hidden.data).all()


def test_supported_shapes():
    assert rnn.supported(64, 512, torch.float32)
    assert rnn.supported(1, 16, torch.float32)
    assert not rnn.supported(65, 512, torch.float32)
    assert not rnn.supported(64, 520, torch.float32)
    assert not rnn.supported(64, 40, torch.float32)
    assert not rnn.supported(64, 512, torch.bfloat16)


def test_wrappers_reject_what_the_kernels_do_not_take():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the kernel would build and run")
    x = torch.empty((L, B, 4 * H), device="meta")
    alive = torch.empty((L, B, 1), device="meta")
    w = torch.empty((H, 4 * H), device="meta")
    h = torch.empty((B, H), device="meta")
    with pytest.raises(ValueError, match="outside the kernel's shapes"):
        rnn.lstm_seq(x.half(), alive, w, h, h)
    with pytest.raises(ValueError, match="contiguous float32"):
        rnn.lstm_seq(x, alive, w.T.contiguous().T, h, h)


# (L, b, H) on the card: the first two, then the hard cases of both
# directions: one step; one batch row and 33 (not a multiple of the 8- or
# 16-row groups or of the mma tiles); H 80, 208 and 496 (not multiples of
# 32: 16 units a block, grids of 20, 52 and 124 blocks); the CTC model's
# 200 frames at the lane's widths
CARD_SHAPES = [(7, 3, 16), (20, 64, 512), (1, 64, 512), (20, 1, 512),
               (20, 33, 512), (20, 64, 80), (20, 33, 208), (200, 64, 512),
               (20, 64, 496)]


def _card_operands(steps, b, hdim, seed=5):
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, steps + 1, b)
    lens[0] = steps
    alive = (np.arange(steps)[:, None] < lens[None, :]) \
        .astype("float32")[..., None]
    arrs = [rng.normal(0, 1, (steps, b, 4 * hdim)), alive,
            rng.normal(0, 0.05, (hdim, 4 * hdim)), rng.normal(0, 1, (b, hdim)),
            rng.normal(0, 1, (b, hdim)),
            rng.normal(0, 1, (steps, b, hdim)) * alive,
            rng.normal(0, 1, (steps, b, hdim)) * alive]
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrs]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_lstm.py on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _float64_fwd(x, alive, w, h0, c0):
    """The forward's recipe (bf16(h)·bf16(w), then the cell) in float64."""
    def bf16(t):
        return t.float().bfloat16().double()

    hdim = h0.shape[-1]
    wb = bf16(w)
    x, alive = x.double(), alive.double()
    h, c = h0.double(), c0.double()
    hs, cs = [], []
    for t in range(x.shape[0]):
        g = x[t] + bf16(h) @ wb
        i, f, u, o = g.split(hdim, -1)
        cn = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
        hn = torch.sigmoid(o) * torch.tanh(cn)
        h = alive[t] * hn + (1 - alive[t]) * h
        c = alive[t] * cn + (1 - alive[t]) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernels_match_the_plain_versions_on_card(shape):
    """The forward's hs and cs within chip_smoke.py phase 5's criteria (1e-2
    of the largest element and 2e-3 in ‖Δ‖₂ of the plain version's, and
    within 2x the plain version's distance to the float64 recipe: the two
    sum in other float32 orders, and bf16(h_{t-1}) moves by a bf16 step now
    and then); the backward, from the kernel's carries, within phase 5's
    limits (1e-2 of the largest element, 2e-3 in ‖Δ‖₂: the bf16 roundings
    of dW_t and of the dh product move by a bf16 step now and then); both
    bitwise the same on a second launch."""
    _need_card()
    x, alive, w, h0, c0, dhs, dcs = _card_operands(*shape)
    rnn.reset_launches()
    hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
    hs2, cs2 = rnn.lstm_seq(x, alive, w, h0, c0)
    grads = rnn.lstm_seq_bwd(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    again = rnn.lstm_seq_bwd(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    torch.cuda.synchronize()
    assert (rnn.launches["lstm_seq"], rnn.launches["lstm_seq_bwd"]) == (2, 2)
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2)
    want = rnn.lstm_seq_torch(x, alive, w, h0, c0)
    exact = _float64_fwd(x, alive, w, h0, c0)
    for name, g, w_, e in zip(("hs", "cs"), (hs, cs), want, exact):
        d = g - w_
        assert (d.abs().max() / w_.abs().max()).item() <= 1e-2, name
        assert (d.norm() / w_.norm()).item() <= 2e-3, name
        k64 = (g.double() - e).abs().max().item()
        p64 = (w_.double() - e).abs().max().item()
        assert k64 <= 2 * p64, (name, k64, p64)
    want = rnn.lstm_seq_bwd_torch(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    for name, g, g2, w_ in zip(("dx", "dw", "dh0", "dc0"), grads, again,
                               want):
        assert torch.equal(g, g2), name
        d = g - w_
        assert ((d.abs().max() / w_.abs().max()).item() <= 1e-2), name
        assert (d.norm() / w_.norm()).item() <= 2e-3, name


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
# lies only in the low 16 bits), ±Inf and ±3.4e38 planted in the carries'
# cotangents: all at the first step, whose dgates reach dx_0, dh0 and the
# dW columns of their units only, and a NaN and -Inf at later steps, which
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
    """NaN and ±Inf in dhs and dcs reach dx, dw, dh0 and dc0 where they
    reach lstm_seq_bwd_torch's: NaN at the same positions, the same
    infinities; the finite rest within the card test's 1e-2. The kernel's
    products split each float32 dgates into three bf16 parts, which must
    carry an infinity and a NaN whole."""
    _need_card()
    x, alive, w, h0, c0, dhs, dcs = _card_operands(20, 16, 512, seed=6)
    alive = torch.ones_like(alive)
    where = [p for p, _ in NAN_PLANTS[plants]]
    bits = [v for _, v in NAN_PLANTS[plants]]
    dhs = _planted(dhs, where, bits)
    dcs = _planted(dcs, where[::2], bits[::2])
    hs, cs = rnn.lstm_seq_torch(x, alive, w, h0, c0)
    got = rnn.lstm_seq_bwd(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    want = rnn.lstm_seq_bwd_torch(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    torch.cuda.synchronize()
    for name, g, w_ in zip(("dx", "dw", "dh0", "dc0"), got, want):
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


# NaN (0x7fffffff, 0xffffffff, and 0x7f800001, a signalling NaN whose
# payload lies only in the low 16 bits, which a truncation to bf16 would
# turn into Inf), ±Inf and ±3.4e38 (which rounds to a bf16 infinity)
# planted in the forward's inputs: in x (t, row, column; each gate), in h0
# and c0 (row, unit), each in a row of its own. A NaN in x reaches its
# cell at step t and its whole row from t + 1 on (through the product); a
# NaN or infinity in h0 its whole row at step 0; one in c0 its cell, then
# its row
def _fwd_plants(hdim, gates):
    col = [k * hdim for k in range(gates)]
    return {
        "x": [((0, 1, col[0] + 3), 0x7FFFFFFF),
              ((5, 2, col[1] + 40), -1),
              ((7, 3, col[gates - 1] + 100), 0x7F800001),
              ((2, 4, col[gates - 1] + 7), _bits(np.inf)),
              ((3, 5, col[0] + 9), _bits(-np.inf)),
              ((4, 6, col[1] + 200), _bits(3.4e38)),
              ((6, 7, col[gates - 2] + 300), _bits(-3.4e38))],
        "h0": [((8, 11), 0x7F800001), ((9, 50), _bits(np.inf)),
               ((10, 60), _bits(3.4e38)), ((11, 70), _bits(-np.inf))],
        "c0": [((12, 5), _bits(np.inf)), ((13, 6), 0x7FFFFFFF),
               ((14, 7), _bits(-3.4e38))],
    }


@pytest.mark.cuda
@pytest.mark.parametrize("hdim", [512, 496])
def test_seq_fwd_propagate_nan_and_inf_on_card(hdim):
    """NaN and ±Inf in x, h0 and c0 reach hs and cs where they reach
    lstm_seq_torch's: NaN at the same positions, the same infinities; the
    finite rest within the card test's 1e-3. bf16(h) must keep a NaN (a
    signalling one too) and round 3.4e38 up to Inf as torch does, and the
    kernel's products must meet them as the plain product does."""
    _need_card()
    x, alive, w, h0, c0, _, _ = _card_operands(20, 16, hdim, seed=7)
    plants = _fwd_plants(hdim, 4)
    x = _planted(x, *zip(*plants["x"]))
    h0 = _planted(h0, *zip(*plants["h0"]))
    c0 = _planted(c0, *zip(*plants["c0"]))
    got = rnn.lstm_seq(x, alive, w, h0, c0)
    want = rnn.lstm_seq_torch(x, alive, w, h0, c0)
    torch.cuda.synchronize()
    for name, g, w_ in zip(("hs", "cs"), got, want):
        nan = torch.isnan(w_)
        assert nan.any(), name
        assert torch.equal(torch.isnan(g), nan), name
        inf = torch.isinf(w_)
        assert torch.equal(torch.isinf(g), inf), name
        assert torch.equal(g[inf], w_[inf]), name
        fin = ~(nan | inf)
        d = (g[fin] - w_[fin]).abs().max() / w_[fin].abs().max()
        assert d.item() <= 1e-3, name
