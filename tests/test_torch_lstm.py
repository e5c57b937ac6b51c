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


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    x, alive, w, h0, c0, dhs, dcs = (torch.from_numpy(a)
                                     for a in _operands(1))
    rnn.reset_launches()
    hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
    grads = rnn.lstm_seq_bwd(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    assert rnn.launches == {"lstm_seq": 0, "lstm_seq_bwd": 0}
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 3, 16), (20, 64, 512)])
def test_kernels_match_the_plain_versions_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_lstm.py on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    steps, b, hdim = shape
    rng = np.random.RandomState(5)
    lens = rng.randint(0, steps + 1, b)
    lens[0] = steps
    alive = (np.arange(steps)[:, None] < lens[None, :]) \
        .astype("float32")[..., None]
    arrs = [rng.normal(0, 1, (steps, b, 4 * hdim)), alive,
            rng.normal(0, 0.05, (hdim, 4 * hdim)), rng.normal(0, 1, (b, hdim)),
            rng.normal(0, 1, (b, hdim)),
            rng.normal(0, 1, (steps, b, hdim)) * alive,
            rng.normal(0, 1, (steps, b, hdim)) * alive]
    x, alive, w, h0, c0, dhs, dcs = (torch.tensor(a, dtype=torch.float32,
                                                  device="cuda")
                                     for a in arrs)
    rnn.reset_launches()
    hs, cs = rnn.lstm_seq(x, alive, w, h0, c0)
    grads = rnn.lstm_seq_bwd(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    torch.cuda.synchronize()
    assert rnn.launches == {"lstm_seq": 1, "lstm_seq_bwd": 1}
    want = rnn.lstm_seq_torch(x, alive, w, h0, c0)
    for g, w_ in zip((hs, cs), want):
        assert ((g - w_).abs().max() / w_.abs().max()).item() <= 1e-3
    want = rnn.lstm_seq_bwd_torch(x, alive, w, h0, c0, hs, cs, dhs, dcs)
    for g, w_ in zip(grads, want):
        assert ((g - w_).abs().max() / w_.abs().max()).item() <= 1e-2
