"""The port's CTC against the reference's: the alpha-recurrence kernel
module's plain versions against the Pallas kernel and the scan's vjp, the
warpctc/warpctc_grad ops on both routes, and the greedy-decoding ops
(top_k, ctc_align, edit_distance).

One batch of 6 rows covers the cases the recurrence treats apart: labels
with repeats (the skip mask), a row of label length 0, a row of one
frame, a row too short for its labels (its loss is ~1e30, and the scan's
gradient there grows threefold a step), a full-length row and a row whose
last labels are padding. Logits, labels and the loss cotangent are seeded
with numpy and fed to both packages. The kernels themselves are held
against the plain versions where a card is present.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import lod as jlod
from paddle_tpu.ops import ctc_ops as jctc
from paddle_tpu.ops.pallas.ctc import ctc_alpha_pallas
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.ops import cuda as ttier
from paddle_tpu_torch.ops.cuda import ctc

T, C = 7, 6
X_LENS = np.array([7, 5, 1, 6, 4, 7], np.int32)
LABELS = [[1, 2, 2], [3, 3], [1], [], [1, 2, 3, 4, 5], [4, 1, 5]]
# losses: float32 sums of logaddexp terms; XLA's and PyTorch's exp and
# log1p differ by a float32 step, measured within 2e-7 relative
LOSS_TOL = dict(rtol=1e-5, atol=0)
# dlogits: the same differences carried back through up to 7 steps of
# logaddexp weights and the log-softmax; measured within 6e-8 of the
# largest element (~1)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    mask = (np.arange(T)[None, :] < X_LENS[:, None])[..., None]
    logits = (rng.normal(0, 1, (len(X_LENS), T, C)) * mask).astype("float32")
    y_lens = np.array([len(v) for v in LABELS], np.int32)
    labels = np.zeros((len(LABELS), y_lens.max(), 1), np.int64)
    for i, v in enumerate(LABELS):
        labels[i, :len(v), 0] = v
    dloss = rng.normal(0, 1, (len(X_LENS), 1)).astype("float32")
    return logits, labels, y_lens, dloss


def test_plain_alpha_matches_the_pallas_kernel():
    logits, labels, y_lens, _ = _batch()
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    xl, yl = torch.from_numpy(X_LENS), torch.from_numpy(y_lens)
    e, alpha0, final0, can_skip, s_valid = ctc.ctc_inputs(
        logp, torch.from_numpy(labels[..., 0]), yl, xl, 0)
    assert e.shape[-1] == 16 and can_skip.shape == s_valid.shape == (6, 16)
    got = ctc.ctc_alpha_torch(e, alpha0, final0, can_skip, s_valid, xl, yl)
    want = ctc_alpha_pallas(*(jnp.asarray(a.numpy()) for a in
                              (e, alpha0, final0, can_skip, s_valid)),
                            jnp.asarray(X_LENS[:, None]),
                            jnp.asarray(y_lens[:, None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
    assert got[4, 0] == pytest.approx(1e30)      # too short for its labels


def test_plain_backward_matches_the_scan_vjp():
    """ctc_loss_bwd_torch (autograd through the port of the scan, then the
    log-softmax) against jax.vjp of the reference's scan on logits."""
    logits, labels, y_lens, dloss = _batch(1)
    lab = labels[..., 0]
    loss, vjp = jax.vjp(lambda lg: jctc._ctc_loss_scan(
        lg, jnp.asarray(X_LENS), jnp.asarray(lab), jnp.asarray(y_lens), 0),
        jnp.asarray(logits))
    want, = vjp(jnp.asarray(dloss))
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    args = (torch.from_numpy(X_LENS), torch.from_numpy(lab),
            torch.from_numpy(y_lens), 0)
    np.testing.assert_allclose(ctc.ctc_scan(logp, *args).numpy(),
                               np.asarray(loss), **LOSS_TOL)
    got = ctc.ctc_loss_bwd_torch(logp, *args, torch.from_numpy(dloss))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    assert (got.numpy()[X_LENS[:, None] <= np.arange(T)[None, :]] == 0).all()
    assert np.isfinite(got.numpy()).all()


def test_ctc_loss_function_pairs_the_wrappers():
    """CtcLoss forward is ctc_alpha on ctc_inputs, its backward
    ctc_loss_bwd; on CPU tensors both are the plain versions and launch
    nothing."""
    logits, labels, y_lens, dloss = _batch(2)
    lg = torch.from_numpy(logits).requires_grad_(True)
    args = (torch.from_numpy(X_LENS), torch.from_numpy(labels[..., 0]),
            torch.from_numpy(y_lens), 0)
    ctc.reset_launches()
    loss = ctc.CtcLoss.apply(lg, *args)
    dlg, = torch.autograd.grad(loss, lg, torch.from_numpy(dloss))
    assert ctc.launches == {"ctc_alpha": 0, "ctc_loss_bwd": 0}
    logp = torch.log_softmax(lg.detach(), -1)
    assert torch.equal(loss.detach(), ctc.ctc_scan(logp, *args))
    assert torch.equal(dlg, ctc.ctc_loss_bwd_torch(logp, *args,
                                                   torch.from_numpy(dloss)))


def _ctc_program(fluid, feeds, norm_by_times):
    """warpctc then warpctc_grad; fetches the loss and dlogits."""
    prog = fluid.Program()
    block = prog.global_block()
    block.create_var(name="logits", dtype="float32", lod_level=1)
    block.create_var(name="label", dtype="int64", lod_level=1)
    block.create_var(name="dloss", dtype="float32")
    for n in ("loss", "dlogits"):
        block.create_var(name=n)
    attrs = {"blank": 0, "norm_by_times": norm_by_times}
    block.append_op("warpctc", inputs={"Logits": ["logits"],
                                       "Label": ["label"]},
                    outputs={"Loss": ["loss"]}, attrs=attrs)
    block.append_op("warpctc_grad",
                    inputs={"Logits": ["logits"], "Label": ["label"],
                            "Loss@GRAD": ["dloss"]},
                    outputs={"Logits@GRAD": ["dlogits"]}, attrs=attrs)
    out = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feeds, fetch_list=["loss", "dlogits"],
        scope=fluid.Scope())
    return [np.asarray(v.data) if hasattr(v, "lens") else np.asarray(v)
            for v in out]


@pytest.mark.parametrize("norm_by_times", [False, True])
@pytest.mark.parametrize("route", ["torch", "cuda"])
def test_warpctc_ops_match_reference(route, norm_by_times):
    """The port's torch route against the reference's scan (jnp tier), and
    its cuda route (the kernel wrappers' plain versions here) against the
    reference's Pallas forward with its scan vjp (pallas tier)."""
    logits, labels, y_lens, dloss = _batch(3)
    jfluid.set_flags({"kernel_tier": {"torch": "jnp",
                                      "cuda": "pallas"}[route]})
    tfluid.set_flags({"kernel_tier": route})
    want = _ctc_program(jfluid, {
        "logits": jlod.LoDArray(logits, X_LENS),
        "label": jlod.LoDArray(labels, y_lens), "dloss": dloss},
        norm_by_times)
    t = torch.from_numpy
    ttier.reset_fallback_counts()
    ctc.reset_launches()
    got = _ctc_program(tfluid, {
        "logits": tlod.LoDArray(t(logits), t(X_LENS)),
        "label": tlod.LoDArray(t(labels), t(y_lens)), "dloss": dloss},
        norm_by_times)
    assert ttier.fallback_counts() == {}
    assert ctc.launches == {"ctc_alpha": 0, "ctc_loss_bwd": 0}
    assert got[0].shape == want[0].shape == (len(X_LENS), 1)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL, err_msg="loss")
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL,
                               err_msg="dlogits")


def test_single_frame_batch_routes_to_the_scan_and_is_counted():
    """T == 1 has no recurrence: under kernel_tier=cuda warpctc takes the
    scan (as the reference does) and the fallback is counted."""
    rng = np.random.RandomState(4)
    logits = rng.normal(0, 1, (2, 1, C)).astype("float32")
    labels = np.array([[[2]], [[0]]], np.int64)
    feeds = {"logits": tlod.LoDArray(torch.from_numpy(logits),
                                     torch.tensor([1, 1], dtype=torch.int32)),
             "label": tlod.LoDArray(torch.from_numpy(labels),
                                    torch.tensor([1, 0], dtype=torch.int32)),
             "dloss": np.ones((2, 1), np.float32)}
    tfluid.set_flags({"kernel_tier": "cuda"})
    ttier.reset_fallback_counts()
    loss, _ = _ctc_program(tfluid, feeds, False)
    assert ttier.fallback_counts() == {"ctc": 2}   # the op and its grad
    lp = logits[:, 0] - np.log(np.exp(logits[:, 0]).sum(-1, keepdims=True))
    np.testing.assert_allclose(loss[:, 0], [-lp[0, 2], -lp[1, 0]],
                               rtol=1e-6)


def _decode_program(fluid, feeds):
    """top_k, then ctc_greedy_decoder and edit_distance, built with each
    package's layers."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        lg = fluid.layers.data("lg", shape=[C], lod_level=1)
        lb = fluid.layers.data("lb", shape=[1], dtype="int64", lod_level=1)
        vals, idx = fluid.layers.topk(lg, k=2)
        decoded = fluid.layers.ctc_greedy_decoder(input=lg, blank=0)
        dist, num = fluid.layers.edit_distance(input=decoded, label=lb,
                                               normalized=True)
        raw, _ = fluid.layers.edit_distance(input=decoded, label=lb)
    out = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feeds, fetch_list=[vals, idx, decoded, dist, raw, num],
        scope=fluid.Scope())
    return [o for o in out]


def test_greedy_decoding_ops_match_reference():
    logits, labels, y_lens, _ = _batch(5)
    # repeated arg-maxes, blanks and a tie on the padded steps
    logits[0, 1] = logits[0, 0]
    logits[1, :3, 0] = 9.0
    want = _decode_program(jfluid, {"lg": jlod.LoDArray(logits, X_LENS),
                                    "lb": jlod.LoDArray(labels, y_lens)})
    t = torch.from_numpy
    got = _decode_program(tfluid, {
        "lg": tlod.LoDArray(t(logits), t(X_LENS)),
        "lb": tlod.LoDArray(t(labels), t(y_lens))})
    for name, g, w_ in zip(("values", "indices"), got[:2], want[:2]):
        np.testing.assert_array_equal(np.asarray(g.data), np.asarray(w_.data),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(g.lens), np.asarray(w_.lens))
    assert got[1].data.dtype == np.int64
    np.testing.assert_array_equal(np.asarray(got[2].lens),
                                  np.asarray(want[2].lens))
    np.testing.assert_array_equal(np.asarray(got[2].data),
                                  np.asarray(want[2].data))
    for name, g, w_ in zip(("normalized", "raw"), got[3:5], want[3:5]):
        assert g.shape == (len(X_LENS), 1)
        np.testing.assert_array_equal(g, np.asarray(w_), err_msg=name)
    assert int(np.asarray(got[5])[0]) == len(X_LENS)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 7, 6, 3), (64, 200, 29, 50)])
def test_kernels_match_the_plain_versions_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_ctc.py on the GPU machine)")
    b, frames, classes, max_u = shape
    rng = np.random.RandomState(6)
    x_lens = rng.randint(2, frames + 1, b).astype(np.int32)
    x_lens[0] = frames
    y_lens = np.minimum(rng.randint(0, max_u + 1, b), x_lens // 2) \
        .astype(np.int32)
    y_lens[1] = max_u
    dev = torch.device("cuda")
    logits = torch.tensor(rng.normal(0, 1, (b, frames, classes)),
                          dtype=torch.float32, device=dev)
    labels = torch.tensor(rng.randint(1, classes, (b, max_u)), device=dev)
    xl = torch.tensor(x_lens, device=dev)
    yl = torch.tensor(y_lens, device=dev)
    dloss = torch.tensor(rng.normal(0, 1, b), dtype=torch.float32,
                         device=dev)
    logp = torch.log_softmax(logits, -1)
    inputs = ctc.ctc_inputs(logp, labels, yl, xl, 0)
    ctc.reset_launches()
    loss = ctc.ctc_alpha(*inputs, xl, yl)
    dlogits = ctc.ctc_loss_bwd(logp, xl, labels, yl, 0, dloss)
    torch.cuda.synchronize()
    assert ctc.launches == {"ctc_alpha": 1, "ctc_loss_bwd": 1}
    want = ctc.ctc_alpha_torch(*inputs, xl, yl)
    finite = want < 1e29
    assert torch.equal(finite, loss < 1e29)
    assert ((loss - want).abs()[finite] / want.abs()[finite]).max() <= 1e-5
    want = ctc.ctc_loss_bwd_torch(logp, xl, labels, yl, 0, dloss)
    rows = finite[:, 0]
    err = (dlogits - want)[rows].abs().max() / want[rows].abs().max()
    assert err.item() <= 1e-4
