"""MobileNet-SSD (PaddlePaddle/models fluid/object_detection/
mobilenet_ssd.py) in the port against the reference (counterpart of
tests/test_ssd_head.py), at scale 0.25 on 96x96 images, where all six
maps stay non-empty (6, 3, 2, 1, 1 and 1 cells a side: 240 priors), batch
2, 21 classes. Each package builds the model with its own front end
(``paddle_tpu_torch.testing.models.mobilenet_ssd``) and the port starts
from the reference's startup state (``torch_cross.ssd_state``: every conv
filter, the depthwise [C, 1, 3, 3] ones among them, the batch-norm scales,
biases, means and variances, and the head's loc/conf convs).

Held on one seeded feed (``models.ssd_feed``: images and 1-4
ground-truth boxes an image):

* the test program (batch norm at its running statistics, the served
  path): multi_box_head's locs, confs, prior boxes and variances within
  1e-5 relative and 1e-5 of their largest element, detection_output's
  rows (counts, labels and order exactly, scores and boxes within 1e-5);
* the training program's step-1 ssd_loss within 1e-4 relative;
* step-1 gradients, four ways (L2, relative to the norm of the second):
  the 24 head gradients (the loc/conf filters and biases, upstream of no
  batch norm) of the port against the reference's within 2e-3 (read:
  6.0e-4 at most); the port's float64 run against the reference's float64
  run (``_reference_float64``) within 1e-6 for each gradient (read: 3.0e-7
  at most, the backbone's 3.7e-8); the reference's
  float32 gradients within 0.15 of the port's float64 ones (read: 9.1e-2
  at most); and the port's float32 gradients no farther from its float64
  ones than twice the reference's distance plus 1e-3 of their norm;
* three Momentum losses (learning rate 1e-3, the model's): steps 2 and 3
  within four times the spread of the reference's own float32 steps,
  which it measures by running the same batch in the reverse order, plus
  1e-4 relative.

The backbone's gradients are not held to 1e-3 because the float32 step
of this net is ill-conditioned at batch 2: training-mode batch norm over
the 1x1, 2x2 and 3x3 maps normalizes 2 to 18 values a channel, and its
backward there is a difference of nearly equal terms (at 2 values a
channel, exactly 0 but for epsilon), so each package's rounding of it
reaches every gradient below. The reference's float32 backbone gradients
lie 3.4% (median L2) from its own run under x64 and from the port's
float64 ones; the port's float32 ones 0.1%; the losses after one update
part by 1-4%, as the reference's own steps on the reversed batch part
from its steps on the batch by 1%."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu_torch.testing import models as M
from torch_cross import (assert_same_program, build_both, host, jfluid,
                         port_scope, ssd_state, tfluid)

SCALE, IMAGE, BATCH, CLASSES = 0.25, 96, 2, M.SSD_CLASSES
PRIORS = 6 * 6 * 4 + (3 * 3 + 2 * 2 + 1 + 1 + 1) * 6
STEPS = 3
HEAD_TOL = 1e-5
ROW_TOL = 1e-5
LOSS_RTOL = 1e-4
SPREAD_FACTOR = 4.0
F64_FACTOR, F64_REL = 2.0, 1e-3
HEAD_GRAD_REL = 2e-3
X64_REL = 1e-6
REF_F64_REL = 0.15


def _build(fluid, dtype="float32"):
    return M.mobilenet_ssd(fluid, scale=SCALE, image=IMAGE, seed=3,
                           dtype=dtype)


def _head(block):
    """The loc/conf convs' filters and biases: each conv whose output gets
    a parameter added."""
    params = {p.name for p in block.all_parameters()}
    biased = {op.input("X")[0]: op.input("Y")[0] for op in block.ops
              if op.type == "elementwise_add" and op.input("Y")[0] in params}
    return {n + "@GRAD" for op in block.ops if op.type == "conv2d"
            and op.output("Output")[0] in biased
            for n in (op.input("Filter")[0], biased[op.output("Output")[0]])}


class _WideNumpy:
    """jax.numpy with float32 read as float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _reference_float64(state64, feed64, fetch):
    """The reference's training program built and run in float64 under
    ``jax.enable_x64``. Its batch norm computes in float32 whatever the
    activations' dtype (paddle_tpu/ops/norm_ops.py ``bn_forward_math``, a
    stability island by design; the port's computes float64 activations
    in float64), which alone moves the backbone's gradients by 2.4%
    (median L2) here, so for this run that module's float32 reads as
    float64."""
    from paddle_tpu.ops import norm_ops
    jfluid.framework.reset_unique_name()
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(norm_ops, "jnp", _WideNumpy())
        main64 = _build(jfluid, "float64")[0]
        scope = jfluid.Scope()
        for k, v in state64.items():
            scope.set(k, v)
        return [host(v) for v in jfluid.Executor(jfluid.CPUPlace()).run(
            main64, feed=feed64, fetch_list=fetch, scope=scope)]


def _as64(feed):
    return {"img": feed["img"].astype(np.float64),
            "gt_box": [b.astype(np.float64) for b in feed["gt_box"]],
            "gt_label": feed["gt_label"]}


@pytest.fixture(scope="module")
def ssd():
    progs = build_both(_build)
    (jmain, jstart, jtest, jv), (tmain, _, ttest, tv) = \
        progs["ref"], progs["port"]
    jexe, jscope, state = ssd_state(jmain, jstart)
    feed = M.ssd_feed(BATCH, IMAGE, 0)
    block = tmain.global_block()
    grads = [p.name + "@GRAD" for p in block.all_parameters()
             if p.trainable and block.has_var(p.name + "@GRAD")]
    head = [tv[k].name for k in ("locs", "confs", "box", "var")]
    texe = tfluid.Executor(tfluid.CPUPlace())

    # the test programs first, from the startup state
    test_fetch = head + [tv["nmsed"].name]
    want_test = [host(v) for v in jexe.run(
        jtest, feed={"img": feed["img"]}, fetch_list=test_fetch,
        scope=jscope)]
    tscope = port_scope(state)
    got_test = [host(v) for v in texe.run(
        ttest, feed={"img": feed["img"]}, fetch_list=test_fetch,
        scope=tscope)]

    fetch = [tv["loss"].name] + grads
    want = [[host(v) for v in jexe.run(jmain, feed=feed, fetch_list=fetch,
                                       scope=jscope)] for _ in range(STEPS)]
    got = [[host(v) for v in texe.run(tmain, feed=feed, fetch_list=fetch,
                                      scope=tscope)] for _ in range(STEPS)]
    reverse = {k: v[::-1] for k, v in feed.items()}
    reverse["img"] = np.ascontiguousarray(reverse["img"])
    _, jscope_r, _ = ssd_state(jmain, jstart)
    spread = [float(host(jexe.run(jmain, feed=reverse, fetch_list=fetch,
                                  scope=jscope_r)[0])) for _ in range(STEPS)]
    state64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
               for k, v in state.items()}
    tfluid.framework.reset_unique_name()
    main64 = _build(tfluid, "float64")[0]
    f64 = [host(v) for v in texe.run(
        main64, feed=_as64(feed), fetch_list=grads,
        scope=tfluid.io.scope_from_numpy(state64, "cpu"))]
    x64 = _reference_float64(state64, _as64(feed), grads)
    return dict(got=got, want=want, f64=f64, x64=x64, spread=spread,
                grads=grads, head=_head(block), state=state,
                got_test=got_test, want_test=want_test, tmain=tmain,
                progs=progs)


def test_the_programs_and_the_carried_state(ssd):
    """The port builds the reference's training and test programs op for
    op, and the state it starts from holds every parameter and
    statistic."""
    progs = ssd["progs"]
    for i in (0, 2):
        assert_same_program(progs["port"][i], progs["ref"][i])
    block = ssd["tmain"].global_block()
    depthwise = [op.input("Filter")[0] for op in block.ops
                 if op.type == "conv2d" and op.attr("groups") > 1]
    assert len(depthwise) == 13 and all(
        ssd["state"][n].shape[1] == 1 for n in depthwise)
    stats = [n for op in block.ops if op.type == "batch_norm"
             for s in ("Scale", "Bias", "Mean", "Variance")
             for n in op.input(s)]
    assert len(stats) == 4 * 35 and set(stats) <= set(ssd["state"])


@pytest.mark.parametrize("i,name", enumerate(["locs", "confs", "box",
                                              "var"]))
def test_multi_box_head(ssd, i, name):
    got, want = ssd["got_test"][i], ssd["want_test"][i]
    shape = {"locs": (BATCH, PRIORS, 4), "confs": (BATCH, PRIORS, CLASSES),
             "box": (PRIORS, 4), "var": (PRIORS, 4)}[name]
    assert want.shape == got.shape == shape
    np.testing.assert_allclose(got, want, rtol=HEAD_TOL,
                               atol=HEAD_TOL * np.abs(want).max())


def test_detection_output_rows(ssd):
    (got, got_lod), (want, want_lod) = ssd["got_test"][4], \
        ssd["want_test"][4]
    assert got_lod == want_lod and want.shape[1] == 6
    assert 0 < len(want) <= BATCH * 200
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0,
                               atol=ROW_TOL)


def test_ssd_loss_and_three_momentum_losses(ssd):
    got = np.array([float(s[0]) for s in ssd["got"]])
    want = np.array([float(s[0]) for s in ssd["want"]])
    spread = np.abs(np.array(ssd["spread"]) - want)
    assert np.all(np.isfinite(got)) and got.shape == (STEPS,)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ssd["spread"][0], want[0], rtol=LOSS_RTOL)
    assert np.all(np.abs(got - want)[1:] <= SPREAD_FACTOR * spread[1:]
                  + LOSS_RTOL * np.abs(want[1:])), (got, want, spread)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("rule", [
    "head_against_the_reference", "float64_against_the_reference",
    "reference_near_the_port_float64", "port_no_farther_than_the_reference"])
def test_step_one_gradients(ssd, rule):
    got, want = ssd["got"][0][1:], ssd["want"][0][1:]
    f64, x64, head = ssd["f64"], ssd["x64"], ssd["head"]
    assert len(got) == len(ssd["grads"]) > 100 and len(head) == 24
    for name, g, w, t, x in zip(ssd["grads"], got, want, f64, x64):
        assert g.shape == w.shape == t.shape == x.shape, name
        if rule == "head_against_the_reference":
            if name in head:
                assert _rel(g, w) <= HEAD_GRAD_REL, (name, _rel(g, w))
        elif rule == "float64_against_the_reference":
            assert _rel(t, x) <= X64_REL, (name, _rel(t, x))
        elif rule == "reference_near_the_port_float64":
            assert _rel(w, t) <= REF_F64_REL, (name, _rel(w, t))
        else:
            d_port, d_ref = _rel(g, t), _rel(w, t)
            assert d_port <= F64_FACTOR * d_ref + F64_REL, (
                name, d_port, d_ref)


def test_served_detections_equal_the_executor(ssd, tmp_path):
    """The test program saved with save_inference_model and served by
    InferenceEngine: requests of 1, 3 and 5 images (buckets 1 and 4: the
    second padded, the third chunked) reply the Executor's rows and counts
    bitwise."""
    from paddle_tpu_torch.serving import InferenceEngine
    ttest = ssd["progs"]["port"][2]
    nmsed = ssd["progs"]["port"][3]["nmsed"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = port_scope(ssd["state"])
    tfluid.io.save_inference_model(str(tmp_path), ["img"], [nmsed], exe,
                                   main_program=ttest, scope=scope)
    eng = InferenceEngine(str(tmp_path), place=tfluid.CPUPlace(),
                          buckets=[1, 4])
    imgs = M.ssd_feed(5, IMAGE, 5)["img"]
    for n in (1, 3, 5):
        (got,) = eng.infer({"img": imgs[:n]})
        (want,) = exe.run(ttest, feed={"img": imgs[:n]},
                          fetch_list=[nmsed], scope=scope)
        assert got.data.shape == (n, 200, 6)
        np.testing.assert_array_equal(got.lens, want.lens)
        np.testing.assert_array_equal(got.data, want.data)
