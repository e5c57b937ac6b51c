"""The port's CTC against the reference's: the alpha-recurrence kernel
module's plain versions against the Pallas kernel (on its own interface
and from the logits, as ``_ctc_loss_pallas`` runs it) and the scan's vjp,
the warpctc/warpctc_grad ops on both routes, and the greedy-decoding ops
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
# the forward from logp against the reference's: chip_smoke.py's limit
# for the kernel against its plain version, relative
CTC_FWD_LIMIT = 1e-5
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


def _edge_batch(blank, seed=7):
    """Logits [8, 9, 6], labels and lengths with the rows the forward
    treats apart: one frame, more frames than T, no label, labels too long
    for their frames, repeated labels, a full row; labels avoid ``blank``."""
    rng = np.random.RandomState(seed)
    frames, classes = 9, 6
    x_lens = np.array([9, 1, 12, 6, 2, 9, 5, 7], np.int32)
    y_lens = np.array([3, 1, 2, 0, 3, 4, 2, 1], np.int32)
    others = [c for c in range(classes) if c != blank]
    labels = np.array(others, np.int64)[rng.randint(0, len(others), (8, 4))]
    labels[5, :3] = labels[5, 0]            # a run of one label
    labels[6, 1] = labels[6, 0]
    logits = rng.normal(0, 1.5, (8, frames, classes)).astype("float32")
    return logits, x_lens, labels, y_lens


def _reference_loss(logits, x_lens, labels, y_lens, blank):
    """The reference's ``_ctc_loss_pallas`` (its XLA glue, then
    ``ctc_alpha_pallas`` in interpret mode on the CPU)."""
    return np.asarray(jctc._ctc_loss_pallas(
        jnp.asarray(logits), jnp.asarray(x_lens), jnp.asarray(labels),
        jnp.asarray(y_lens), blank))


def _port_loss(logits, x_lens, labels, y_lens, blank):
    logp = torch.log_softmax(torch.from_numpy(logits), -1)
    return ctc.ctc_loss_fwd_torch(logp, torch.from_numpy(x_lens),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(y_lens), blank).numpy()


@pytest.mark.parametrize("blank", [0, 4])
def test_plain_forward_from_logp_matches_the_reference(blank):
    """ctc_loss_fwd_torch, the plain version of the kernel that starts from
    logp and the labels, against the reference's forward from the logits,
    within CTC_FWD_LIMIT: one-frame rows, rows longer than T and rows too
    short for their labels (1e30 in both), no label, repeats."""
    args = _edge_batch(blank)
    want = _reference_loss(*args, blank)
    got = _port_loss(*args, blank)
    assert got.shape == want.shape == (8, 1)
    np.testing.assert_allclose(got, want, rtol=CTC_FWD_LIMIT, atol=0)
    assert got[2, 0] == want[2, 0] == np.float32(1e30)     # x_len > T
    assert got[4, 0] == pytest.approx(1e30)     # too short for its labels
    assert np.isfinite(got[[0, 1, 3, 5, 6, 7]]).all()
    assert got[1, 0] < 1e29                     # one frame, one label


def test_plain_forward_propagates_nan_and_inf_as_the_reference():
    """NaN and ±Inf planted in the logits give the reference's pattern of
    NaN, +Inf and 1e30 in the loss: a NaN logit (its frame's log-softmax
    is NaN) or +Inf (the same), -Inf at every class a row's path can take
    at its last frame (+Inf; at an earlier frame the -1e30 of the states
    no path reaches takes over, and the loss is 1e30), -Inf at one label's
    class (finite; 1e30 in a one-frame row), NaN past a row's frames (not
    read); the finite rest within CTC_FWD_LIMIT."""
    logits, x_lens, labels, y_lens = _edge_batch(0, seed=9)
    logits[0, 4, int(labels[0, 1])] = np.nan
    logits[3, 2, 2] = np.inf
    logits[5, 8, [0] + [int(v) for v in labels[5]]] = -np.inf
    logits[1, 0, int(labels[1, 0])] = -np.inf   # one frame: 1e30
    logits[6, 2, int(labels[6, 0])] = -np.inf
    logits[7, 8, 0] = np.nan                    # past x_len 7
    want = _reference_loss(logits, x_lens, labels, y_lens, 0)
    got = _port_loss(logits, x_lens, labels, y_lens, 0)
    nan = np.isnan(want)
    assert nan[[0, 3], 0].all() and np.isposinf(want[5, 0])
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    fin = ~nan & ~np.isinf(want)
    assert np.isfinite(got[fin]).all() and (want[fin] >= 1e29).any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=CTC_FWD_LIMIT,
                               atol=0)


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
    """CtcLoss forward is ctc_alpha on the log-softmax, its backward
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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_ctc.py on the GPU machine)")


# (b, frames, classes, max label length) on the card: the test batch's
# size, the CTC model's (b 64, T 200, Sp 104), a long utterance whose
# [T, Sp] (1000 x 408) is far beyond a block's shared memory, and Sp 144,
# just past one state a chain thread (K > 1)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 7, 6, 3), (64, 200, 29, 50),
                                   (4, 1000, 29, 200), (16, 300, 29, 70)])
def test_kernels_match_the_plain_versions_on_card(shape):
    """The forward from logp bitwise the plain version's float32 loss where
    it is finite (the same operations in the same order), the 1e30 rows
    alike; dlogits within phase 7's 1e-4 of the largest."""
    _need_card()
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
    ctc.reset_launches()
    loss = ctc.ctc_alpha(logp, xl, labels, yl, 0)
    dlogits = ctc.ctc_loss_bwd(logp, xl, labels, yl, 0, dloss)
    torch.cuda.synchronize()
    assert ctc.launches == {"ctc_alpha": 1, "ctc_loss_bwd": 1}
    want = ctc.ctc_loss_fwd_torch(logp, xl, labels, yl, 0)
    finite = want < 1e29
    assert torch.equal(finite, loss < 1e29)
    assert torch.equal(loss[finite], want[finite])
    want = ctc.ctc_loss_bwd_torch(logp, xl, labels, yl, 0, dloss)
    rows = finite[:, 0]
    err = (dlogits - want)[rows].abs().max() / want[rows].abs().max()
    assert err.item() <= 1e-4


def _bits(v):
    return int(np.array(v, np.float32).view(np.int32))


def _planted_batch():
    """logp [10, 50, 6], labels, x_lens, y_lens and dloss on the CPU, with
    NaN and ±Inf planted in logp and in dloss, each plant in a row of its
    own: a label's class (mid-row, near the row's last frame, and two
    frames before it, where it cannot reach the final states), a class no
    label has, the blank, a frame past the row's length; NaN and ±Inf in
    dloss."""
    b, frames, classes = 10, 50, 6
    rng = np.random.RandomState(8)
    x_lens = np.array([40, 50, 50, 50, 30, 50, 50, 45, 50, 44], np.int32)
    y_lens = np.array([4, 5, 3, 5, 4, 5, 5, 4, 5, 5], np.int32)
    labels = rng.randint(1, classes - 1, (b, 5))   # class 5 is no label's
    logits = rng.normal(0, 1, (b, frames, classes))
    dloss = rng.normal(0, 1, b)
    logp = torch.log_softmax(torch.tensor(logits, dtype=torch.float32), -1)
    plants = [((0, 20, int(labels[0, 1])), 0x7FFFFFFF),
              ((1, 5, 0), _bits(np.inf)),
              ((2, 7, int(labels[2, 0])), _bits(-np.inf)),
              ((3, 3, classes - 1), 0x7F800001),
              ((4, 40, int(labels[4, 0])), -1),
              ((7, 44, int(labels[7, 3])), 0x7FFFFFFF),
              ((8, 30, int(labels[8, 2])), _bits(np.inf)),
              ((9, 41, int(labels[9, 0])), 0x7FFFFFFF)]
    for idx, v in plants:
        logp.view(torch.int32)[idx] = v
    dl = torch.tensor(dloss, dtype=torch.float32)
    dl.view(torch.int32)[5] = 0x7FFFFFFF
    dl.view(torch.int32)[6] = _bits(np.inf)
    dl.view(torch.int32)[7] = _bits(-np.inf)
    return (logp, torch.tensor(x_lens), torch.tensor(labels),
            torch.tensor(y_lens), dl)


def _finite_batch():
    """A batch of finite inputs with the rows the kernel treats apart: the
    full length, one frame, no label, a row too short for its labels."""
    rng = np.random.RandomState(3)
    b, frames, classes = 6, 30, 7
    x_lens = np.array([30, 20, 1, 25, 4, 30], np.int32)
    y_lens = np.array([5, 3, 0, 6, 4, 2], np.int32)
    logp = torch.log_softmax(torch.tensor(
        rng.normal(0, 1, (b, frames, classes)), dtype=torch.float32), -1)
    return (logp, torch.tensor(x_lens),
            torch.tensor(rng.randint(1, classes, (b, 6))),
            torch.tensor(y_lens),
            torch.tensor(rng.normal(0, 1, b), dtype=torch.float32))


def _assert_same_pattern(got, want, tol):
    """NaN at the same positions, the same infinities, the finite rest
    within ``tol`` of the largest finite element."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    fin = ~(nan | inf)
    d = (got[fin] - want[fin]).abs().max() / want[fin].abs().max()
    assert d.item() <= tol


def _lae(a, b):
    d = np.float32(a - b)
    if np.isnan(d):
        return np.float32(a + b)
    return np.float32(max(a, b)) + np.float32(np.log1p(np.exp(-abs(d))))


def _rinf(v):
    return np.float32(0) if v == np.inf else v


def _kernel_model_row(lp, lab, xlen, ylen, dloss, sp):
    """One row of csrc/ctc.cu's backward, decomposed as the kernel computes
    it, in float32 numpy scalars: alpha over the real steps 1..tr; the
    adjoint from tb (tr + 1 where steps follow, from a cotangent of 0)
    down to 1, each alpha_t's cotangent completed with its final's terms
    (the loss's at the selected final, 0 * weight at the others), the
    weights with +inf read as 0; the emissions' cotangents scattered onto
    the classes in increasing s, the classes summed in increasing c; past
    tr, 0 - exp(logp) * 0."""
    f32, neg = np.float32, np.float32(-1e30)
    frames, classes = lp.shape
    last, final_on = 2 * ylen, 1 <= xlen <= frames
    tr = 0 if xlen < 1 else min(xlen, frames) - 1
    out = f32(0) - np.exp(lp) * f32(0)
    z = [lab[s >> 1] if s & 1 and s < 2 * len(lab) + 1 else 0
         for s in range(sp)]
    valid = [s <= last for s in range(sp)]
    skip = [bool(s & 1 and s >= 2 and z[s] != z[s - 2]) for s in range(sp)]
    alpha = np.full((frames, sp), neg, np.float32)
    alpha[0, 0] = lp[0, z[0]]
    if ylen > 0:
        alpha[0, 1] = lp[0, z[1]]
    for t in range(1, tr + 1):
        a = alpha[t - 1]
        for s in range(sp):
            m = _lae(_lae(a[s], a[s - 1] if s >= 1 else neg),
                     a[s - 2] if skip[s] else neg)
            alpha[t, s] = f32(m + lp[t, z[s]]) if valid[s] else neg
    g, de = np.zeros(sp, np.float32), np.zeros((frames, sp), np.float32)

    def finals(t):
        al, am = alpha[t, last], alpha[t, last - 1] if ylen > 0 else neg
        rf = _rinf(_lae(al, am))
        real = final_on and t == tr
        for e, x in enumerate((al, am)[:2 if ylen > 0 else 1]):
            w = f32(np.exp(f32(_rinf(x) - rf)))
            if real:
                g[last - e] = f32(g[last - e] + f32(f32(-dloss) * w))
            if not real or tr < frames - 1:
                g[last - e] = f32(g[last - e] + f32(f32(0) * w))

    for t in range(tr + 1 if tr < frames - 1 else tr, 0, -1):
        if t <= tr:
            finals(t)
        a = alpha[t - 1]
        g0, g1, g2 = (np.zeros(sp, np.float32) for _ in range(3))
        for s in range(sp):
            a1 = a[s - 1] if s >= 1 else neg
            a2 = a[s - 2] if skip[s] else neg
            inner = _lae(a[s], a1)
            merged = _lae(inner, a2)
            gn = g[s] if valid[s] else f32(0)
            gi = f32(gn * np.exp(f32(_rinf(inner) - _rinf(merged))))
            if t <= tr:
                de[t, s] = gn
            g0[s] = f32(gi * np.exp(f32(_rinf(a[s]) - _rinf(inner))))
            if s >= 1:
                g1[s] = f32(gi * np.exp(f32(_rinf(a1) - _rinf(inner))))
            if skip[s]:
                g2[s] = f32(gn * np.exp(f32(_rinf(a2) - _rinf(merged))))
        for s in range(sp):
            v = g0[s]
            if s + 1 < sp:
                v = f32(v + g1[s + 1])
            if s + 2 < sp:
                v = f32(v + g2[s + 2])
            g[s] = v
    finals(0)
    de[0, :2] = [g[0], g[1] if ylen > 0 else 0]
    for t in range(tr + 1):
        dl = np.zeros(classes, np.float32)
        for s in range(sp):
            if z[s] < classes:
                dl[z[s]] = f32(dl[z[s]] + de[t, s])
        tot = f32(0)
        for c in range(classes):
            tot = f32(tot + dl[c])
        out[t] = (dl - (np.exp(lp[t]) * tot).astype(np.float32))
    return out


@pytest.mark.parametrize("batch", ["finite", "planted"])
def test_backward_kernel_decomposition_matches_the_plain_version(batch):
    """The backward kernel's decomposition (csrc/ctc.cu, modelled per row by
    _kernel_model_row) gives the plain version's dlogits (autograd of the
    scan), NaN and ±Inf included: within GRAD_TOL's atol of the largest
    finite element."""
    logp, xl, labels, yl, dloss = {"finite": _finite_batch,
                                   "planted": _planted_batch}[batch]()
    want = ctc.ctc_loss_bwd_torch(logp, xl, labels, yl, 0, dloss)
    sp = ctc.label_positions(labels.shape[1])
    with np.errstate(all="ignore"):
        got = torch.from_numpy(np.stack([
            _kernel_model_row(logp[r].numpy(), labels[r, :].tolist(),
                              int(xl[r]), int(yl[r]), dloss[r].numpy(), sp)
            for r in range(logp.shape[0])]))
    if batch == "planted":
        assert torch.isnan(want).any() and torch.isinf(want).any()
    _assert_same_pattern(got, want, GRAD_TOL["atol"])


@pytest.mark.cuda
def test_loss_bwd_propagates_nan_and_inf_on_card():
    """NaN and ±Inf planted in logp and in dloss (_planted_batch) reach
    dlogits where they reach ctc_loss_bwd_torch's (autograd of the scan:
    its weights read +inf as 0, and the finals it does not select and the
    steps after a row's frames add 0 * weight): NaN at the same positions,
    the same infinities, the finite rest within phase 7's 1e-4 of the
    largest."""
    _need_card()
    dev = torch.device("cuda")
    logp, xl, labels, yl, dloss = (t.to(dev) for t in _planted_batch())
    got = ctc.ctc_loss_bwd(logp, xl, labels, yl, 0, dloss)
    want = ctc.ctc_loss_bwd_torch(logp, xl, labels, yl, 0, dloss)
    torch.cuda.synchronize()
    assert torch.isnan(want).any() and torch.isinf(want).any()
    _assert_same_pattern(got, want, 1e-4)


@pytest.mark.cuda
def test_loss_fwd_propagates_nan_and_inf_on_card():
    """NaN and ±Inf planted in logp (_planted_batch) reach the forward's
    loss where they reach ctc_loss_fwd_torch's: NaN in the same rows, the
    same infinities, the finite rest bitwise."""
    _need_card()
    dev = torch.device("cuda")
    logp, xl, labels, yl, _ = (t.to(dev) for t in _planted_batch())
    got = ctc.ctc_alpha(logp, xl, labels, yl, 0)
    want = ctc.ctc_loss_fwd_torch(logp, xl, labels, yl, 0)
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    _assert_same_pattern(got, want, 0.0)
