"""Helpers for the tests that hold a port program against the reference's:
build one program with each package's front end, give the port the
reference's startup state by name, run both on the same numpy feeds on the
CPU and compare."""

import importlib.util
import pathlib

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.testing import models as M


def build_both(build):
    """{"ref": build(jfluid), "port": build(tfluid)}, each from fresh
    unique names, so the two programs name their variables alike."""
    out = {}
    for key, fluid in (("ref", jfluid), ("port", tfluid)):
        fluid.framework.reset_unique_name()
        out[key] = build(fluid)
    return out


def ref_state(main, startup, mode="jit"):
    """The reference's executor and a scope holding its startup state, and
    that state as {name: np.ndarray} of every persistable the programs
    name."""
    exe = jfluid.Executor(jfluid.CPUPlace(), mode=mode)
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    names = {v.name for p in (main, startup)
             for v in p.global_block().vars.values()
             if v.persistable and not v.is_data}
    state = {n: np.array(scope.find_var(n)) for n in sorted(names)
             if scope.find_var(n) is not None}
    return exe, scope, state


def ssd_state(main, startup, mode="jit"):
    """``ref_state`` of a detection model (MobileNet-SSD), checked whole:
    every persistable the training program declares (the conv filters, the
    depthwise [C, 1, 3, 3] ones among them, the batch-norm scales, biases,
    means and variances, the head's loc/conf filters and biases, the
    momentum velocities and the learning rate) is in the state, at its
    declared shape."""
    exe, scope, state = ref_state(main, startup, mode)
    for v in main.global_block().vars.values():
        if not v.persistable or v.is_data:
            continue
        assert v.name in state, f"{v.name} is not carried across"
        if v.shape is not None and all(s > 0 for s in v.shape):
            assert state[v.name].shape == tuple(v.shape), (
                v.name, state[v.name].shape, v.shape)
    return exe, scope, state


def port_scope(state):
    """A port scope holding ``state`` on the CPU."""
    return tfluid.io.scope_from_numpy(state, "cpu")


def run_steps(exe, main, scope, feed, fetch, steps):
    """``steps`` runs of ``main`` on one feed; per step the fetches as
    numpy arrays (a LoD fetch as its flat data and offsets)."""
    out = []
    for _ in range(steps):
        vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        out.append([host(v) for v in vals])
    return out


def host(v):
    """A fetched value on the host: an array, or (flat, lod) of a LoD
    value of either package."""
    if hasattr(v, "lens"):
        if hasattr(v, "tree_flatten"):
            from paddle_tpu.core.lod import lodarray_to_flat
        else:
            from paddle_tpu_torch.core.lod import lodarray_to_flat
        flat, lod = lodarray_to_flat(v)
        return np.asarray(flat), lod
    return np.asarray(v)


def assert_close(got, want, rtol, atol=0.0, what=""):
    """Equal structure; LoD offsets equal; arrays within tolerance."""
    if isinstance(want, tuple):
        assert got[1] == want[1], (what, got[1], want[1])
        got, want = got[0], want[0]
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def cross_run(build, feed, fetch, steps=1, mode="jit"):
    """``build`` in both packages, the port from the reference's startup
    state, ``steps`` runs of each on ``feed``: (port fetches, reference
    fetches, the programs), fetches per step as ``run_steps`` gives
    them."""
    progs = build_both(build)
    jmain, jstartup = progs["ref"][:2]
    tmain = progs["port"][0]
    jexe, jscope, state = ref_state(jmain, jstartup, mode)
    want = run_steps(jexe, jmain, jscope, feed, fetch, steps)
    got = run_steps(tfluid.Executor(tfluid.CPUPlace()), tmain,
                    port_scope(state), feed, fetch, steps)
    return got, want, progs


# input slots the port's recurrent grads add: they read their forward's
# outputs, whose carries the kernel route replays (ops/rnn_ops.py)
PORT_GRAD_READS = {"lstm_grad": ("Hidden", "Cell"), "gru_grad": ("Hidden",)}


def assert_same_program(port, ref):
    """The two programs op for op and variable for variable alike: op
    types, slots, attrs, and every variable's name, dtype, shape and LoD
    level (their ``to_dict()`` forms equal), but for the forward outputs
    the port's lstm_grad and gru_grad read besides (PORT_GRAD_READS)."""
    tdict, jdict = port.to_dict(), ref.to_dict()
    for tb, jb in zip(tdict["blocks"], jdict["blocks"]):
        assert [o["type"] for o in tb["ops"]] == \
            [o["type"] for o in jb["ops"]]
        for op in tb["ops"]:
            for slot in PORT_GRAD_READS.get(op["type"], ()):
                op["inputs"].pop(slot)
    assert tdict == jdict


def cross_losses(progs, feed, steps=5, rtol=1e-5, mode="jit"):
    """``build_both``'s (main, startup, loss) pair run ``steps`` times on
    one feed, the port from the reference's startup state: the losses
    within ``rtol`` at every step. Returns (port, reference) losses."""
    jmain, jstartup, jloss = progs["ref"][:3]
    tmain, tloss = progs["port"][0], progs["port"][2]
    jexe, jscope, state = ref_state(jmain, jstartup, mode)
    want = run_steps(jexe, jmain, jscope, feed, [jloss.name], steps)
    got = run_steps(tfluid.Executor(tfluid.CPUPlace()), tmain,
                    port_scope(state), feed, [tloss.name], steps)
    got = np.array([g[0] for g in got], np.float64).reshape(steps, -1)
    want = np.array([w[0] for w in want], np.float64).reshape(steps, -1)
    np.testing.assert_allclose(got, want, rtol=rtol)
    return got, want


# float32 op outputs: rtol 1e-5 and atol 1e-6 of the largest element (sums
# in another order); integer and bool outputs exactly
OP_RTOL, OP_ATOL_REL = 1e-5, 1e-6


def run_op(fluid, op_type, inputs, outputs, attrs, feeds, lod=()):
    """One op as a one-op program of ``fluid``'s package over ``feeds``
    (the reference's eager executor); the names in ``lod`` are fed as
    lists of sequences to lod_level-1 vars. Returns every output, in slot
    order, as ``host`` gives it."""
    prog = fluid.Program()
    block = prog.global_block()
    for name, arr in feeds.items():
        if name in lod:
            block.create_var(name=name, dtype=str(np.asarray(arr[0]).dtype),
                             lod_level=1)
        else:
            block.create_var(name=name, shape=np.shape(arr),
                             dtype=str(np.asarray(arr).dtype))
    fetch = [n for names in outputs.values() for n in names]
    for n in fetch:
        if not block.has_var(n):
            block.create_var(name=n)
    block.append_op(op_type, inputs=inputs, outputs=outputs, attrs=attrs)
    exe = jfluid.Executor(jfluid.CPUPlace(), mode="eager") \
        if fluid is jfluid else fluid.Executor(fluid.CPUPlace())
    return [host(v) for v in exe.run(prog, feed=feeds, fetch_list=fetch,
                                     scope=fluid.Scope())]


def assert_op_close(got, want, what=""):
    """``got`` against ``want`` at the op tolerance: floats within rtol
    1e-5 / atol 1e-6 of want's largest element, anything else exact."""
    if isinstance(want, tuple):
        assert got[1] == want[1], (what, got[1], want[1])
        got, want = got[0], want[0]
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=OP_RTOL,
                                   atol=OP_ATOL_REL * scale, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def op_both(op_type, inputs, outputs, attrs, feeds, lod=()):
    """``run_op`` in both packages, every output held by
    ``assert_op_close``; returns the port's outputs."""
    want = run_op(jfluid, op_type, inputs, outputs, attrs, feeds, lod)
    got = run_op(tfluid, op_type, inputs, outputs, attrs, feeds, lod)
    names = [n for ns in outputs.values() for n in ns]
    for name, g, w in zip(names, got, want):
        assert_op_close(g, w, f"{op_type} {name}")
    return got


def f32(rng, *shape, scale=1.0):
    return rng.normal(0, scale, shape).astype("float32")


def fwd_grad(op_type, ins, outs, attrs, feeds, grad_ins, grad_outs, rng,
              cot="Out"):
    """``op_both`` of the forward op, then of its grad op fed the
    forward's outputs and a seeded cotangent of the ``cot`` output; returns
    the port's forward outputs."""
    got = op_both(op_type, ins, outs, attrs, feeds)
    out_vals = dict(zip([n for ns in outs.values() for n in ns], got))
    d = outs[cot][0]
    gfeeds = {n: v for n, v in {**feeds, **out_vals}.items()
              if any(n in ns for ns in grad_ins.values())}
    dshape = np.shape(out_vals[d][0] if isinstance(out_vals[d], tuple)
                      else out_vals[d])
    if op_type == "im2sequence":      # the padded [b, steps, d] cotangent
        dshape = (feeds["x"].shape[0], dshape[0] // feeds["x"].shape[0],
                  dshape[1])
    gfeeds["d"] = f32(rng, *dshape)
    op_both(op_type + "_grad", {**grad_ins, cot + "@GRAD": ["d"]},
            grad_outs, attrs, gfeeds)
    return got


# ---------------------------------------------------------------------------
# the book chapters (tests/test_torch_book_*.py, a file a chapter)
# ---------------------------------------------------------------------------
# The book chapters (tests/book/) in the port against the reference.
#
# Parity: each chapter's model, built by both front ends at narrow widths
# from ``paddle_tpu_torch.testing.models``, the port given the reference's
# startup state, five steps on one seeded synthetic batch: the losses within
# 1e-4 relative at every step, every step-1 parameter gradient within 1e-4
# of its largest element; SRL's per-sequence CRF cost too, and its Viterbi
# paths exactly. A bias added just before a training-mode batch_norm has a
# gradient of 0 in exact arithmetic (the mean subtraction cancels it), so
# both packages give rounding noise there: it is held to 1e-4 of the
# chapter's largest gradient element. vgg16_bn_drop runs with every
# dropout rate 0 (the packages draw their masks from different generators;
# a rate-0 mask keeps every element in both).
#
# Contracts: each chapter's reference test from tests/book, run with the
# port's fluid in place of the reference's (its synthetic data from
# paddle_tpu.dataset's generators, nothing downloaded), under the port's
# verify_passes and executor_verify as tests/book/conftest.py runs the
# reference's: MNIST's MLP, CIFAR's ResNet and VGG, the inference round
# trip (batch_norm with is_test after loading), both sentiment nets, SRL
# with its decode and chunk F1, and the recommender.

BOOK_STEPS = 5
BOOK_LOSS_RTOL = 1e-4
BOOK_GRAD_REL = 1e-4

SRL_SIZES = dict(word_dict=60, pred_dict=10, label_dict=9)
REC_SIZES = dict(users=20, jobs=5, movies=30, categories=6, title_dict=40)
CHAPTERS = {
    "digits_mlp": (lambda f: M.digits_mlp(f, hidden=(32, 16)),
                   "digits_mlp", 16, {}),
    "digits_conv": (lambda f: M.digits_conv(f, filters=(4, 8)),
                    "digits_conv", 8, {}),
    "cifar_resnet": (lambda f: M.cifar_resnet(f, depth=8,
                                              widths=(4, 8, 16)),
                     "cifar", 8, {}),
    "cifar_vgg": (lambda f: M.cifar_vgg(
        f, blocks=((4, 2, (0.3, 0.0)), (8, 2, (0.4, 0.0))), fc=16,
        drop=0.0), "cifar", 8, {}),
    "sentiment_conv": (lambda f: M.sentiment_conv(f, 50, emb=8, hid=8),
                       "sentiment", 8, dict(dict_dim=50, lens=(3, 9))),
    "sentiment_lstm": (lambda f: M.sentiment_lstm(f, 50, emb=8, hid=32),
                       "sentiment", 8, dict(dict_dim=50, lens=(3, 9))),
    "srl": (lambda f: M.srl_db_lstm(f, **SRL_SIZES, word_dim=8, mark_dim=3,
                                    hidden=16, depth=3),
            "srl", 8, dict(SRL_SIZES, lens=(3, 9))),
    "recommender": (lambda f: M.recommender(f, **REC_SIZES), "recommender",
                    16, REC_SIZES),
}


def _grad_names(main):
    block = main.global_block()
    return [p.name + "@GRAD" for p in block.all_parameters()
            if p.trainable and block.has_var(p.name + "@GRAD")]


def _cancelled_by_batch_norm(main):
    """Gradient names of the biases whose elementwise_add feeds a
    training-mode batch_norm directly."""
    ops = main.global_block().ops
    bn_inputs = {op.input("X")[0] for op in ops
                 if op.type == "batch_norm" and not op.attr("is_test")}
    return {op.input("Y")[0] + "@GRAD" for op in ops
            if op.type == "elementwise_add" and op.output("Out")[0]
            in bn_inputs}


def _host(v):
    if hasattr(v, "to_dense"):
        v = v.to_dense()
    if hasattr(v, "lens"):
        return np.asarray(v.data), np.asarray(v.lens)
    return np.asarray(v)


def _book_run(exe, main, scope, feed, fetch):
    """BOOK_STEPS runs with one fetch list (the reference compiles one step)."""
    return [[_host(v) for v in exe.run(main, feed=feed, scope=scope,
                                       fetch_list=fetch)]
            for _ in range(BOOK_STEPS)]


def book_parity(chapter):
    """One chapter built by both front ends, the port from the
    reference's startup state, BOOK_STEPS steps each on one synthetic
    batch: the losses within BOOK_LOSS_RTOL at every step, every step-1
    gradient within BOOK_GRAD_REL of its largest element (of the
    chapter's largest where a training-mode batch_norm cancels it in
    exact arithmetic); SRL's CRF cost and Viterbi paths too."""
    build, kind, batch, sizes = CHAPTERS[chapter]
    progs = build_both(build)
    (jmain, jstart, jv), (tmain, _, tv) = progs["ref"], progs["port"]
    feed = M.book_feed(kind, batch, 0, **sizes)
    fetch = [jv["loss"].name]
    if chapter == "srl":
        fetch += [jv["crf_cost"].name, jv["decode"].name]
    grads = _grad_names(tmain)
    assert grads and grads == _grad_names(jmain)
    jexe, jscope, state = ref_state(jmain, jstart)
    want = _book_run(jexe, jmain, jscope, feed, fetch + grads)
    got = _book_run(tfluid.Executor(tfluid.CPUPlace()), tmain, port_scope(state),
               feed, fetch + grads)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], rtol=BOOK_LOSS_RTOL,
                                   err_msg=f"{chapter} loss, step {step}")
        if chapter == "srl":
            np.testing.assert_allclose(g[1], w[1], rtol=BOOK_LOSS_RTOL,
                                       err_msg=f"CRF cost, step {step}")
            (gp, gl), (wp, wl) = g[2], w[2]
            np.testing.assert_array_equal(gl, wl)
            for i, n in enumerate(wl):
                np.testing.assert_array_equal(
                    gp[i, :n], wp[i, :n],
                    err_msg=f"Viterbi path {i}, step {step}")
    gw = list(zip(grads, got[0][len(fetch):], want[0][len(fetch):]))
    largest = max(float(np.max(np.abs(w))) for _, _, w in gw)
    cancelled = _cancelled_by_batch_norm(tmain)
    for name, g, w in gw:
        scale = largest if name in cancelled else float(np.max(np.abs(w)))
        assert np.max(np.abs(g - w)) <= BOOK_GRAD_REL * scale, (
            chapter, name, float(np.max(np.abs(g - w))), scale)
    losses = [float(s[0]) for s in got]
    assert losses[-1] < losses[0], (chapter, losses)


BOOK_DIR = pathlib.Path(__file__).resolve().parent / "book"


def _book_module(name):
    spec = importlib.util.spec_from_file_location(f"_port_book_{name}",
                                                  BOOK_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def port_book(monkeypatch):
    """Load a tests/book module with the port's fluid in its ``fluid``
    (and ``layers``) globals, its own global scope fresh, and the port's
    verifier on every program, as tests/book/conftest.py sets the
    reference's."""
    from paddle_tpu_torch.core.scope import reset_global_scope
    old = {k: tfluid.get_flag(k) for k in ("verify_passes",
                                           "executor_verify")}
    tfluid.set_flags({k: True for k in old})
    reset_global_scope()

    def load(name):
        mod = _book_module(name)
        monkeypatch.setattr(mod, "fluid", tfluid)
        if hasattr(mod, "layers"):
            monkeypatch.setattr(mod, "layers", tfluid.layers)
        return mod
    yield load
    tfluid.set_flags(old)
    reset_global_scope()


CONTRACTS = [
    ("test_recognize_digits", "test_recognize_digits_mlp_converges", {}),
    ("test_image_classification", "test_image_classification_converges",
     {"net": "resnet"}),
    ("test_image_classification", "test_image_classification_converges",
     {"net": "vgg"}),
    ("test_image_classification",
     "test_image_classification_inference_roundtrip", {}),
    ("test_understand_sentiment", "test_understand_sentiment_converges",
     {"net": "conv"}),
    ("test_understand_sentiment", "test_understand_sentiment_converges",
     {"net": "stacked_lstm"}),
    ("test_label_semantic_roles",
     "test_label_semantic_roles_converges_and_decodes", {}),
    ("test_recommender_system", "test_recommender_converges", {}),
]


def contract_cases(*which):
    """pytest parameters of the CONTRACTS whose test name or net is in
    ``which``, with the ids the one-file suite gave them."""
    cases = [c for c in CONTRACTS
             if c[1] in which or c[2].get("net") in which]
    return cases, [f"{t}-{k.get('net', '')}".rstrip("-")
                   for _, t, k in cases]


def book_contract(port_book, tmp_path, module, test, kwargs):
    """Run one tests/book contract with the port's fluid."""
    fn = getattr(port_book(module), test)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    fn(**kwargs)


# ---------------------------------------------------------------------------
# a one-off reading, not a test: the repo tests' Adam rates at the book's
# widths. PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_cross.py
# ---------------------------------------------------------------------------

# chip_smoke.py phase 19's sizes (the book's widths and batches)
BOOK_RATES = {
    "stacked_lstm_net, Adam 0.01": (
        lambda f: M.sentiment_lstm(f, 5000, lr=0.01), "sentiment", 64,
        dict(dict_dim=5000, lens=(10, 100))),
    "db_lstm (SRL), Adam 2e-3": (
        lambda f: M.srl_db_lstm(f, 30000, 3000, 59, lr=2e-3), "srl", 10,
        dict(word_dict=30000, pred_dict=3000, label_dict=59,
             lens=(10, 50))),
}


def book_rate_losses(name, steps=5):
    """Both packages' losses over ``steps`` steps on one synthetic batch
    (seed 0), the port from the reference's startup state."""
    build, kind, batch, sizes = BOOK_RATES[name]
    progs = build_both(build)
    (jmain, jstart, jv), (tmain, _, tv) = progs["ref"], progs["port"]
    feed = M.book_feed(kind, batch, 0, **sizes)
    jexe, jscope, state = ref_state(jmain, jstart)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), port_scope(state)
    want = [float(np.asarray(jexe.run(jmain, feed=feed, scope=jscope,
                                      fetch_list=[jv["loss"]])[0]))
            for _ in range(steps)]
    got = [float(texe.run(tmain, feed=feed, scope=tscope,
                          fetch_list=[tv["loss"]])[0]) for _ in range(steps)]
    return want, got


if __name__ == "__main__":
    for rate in BOOK_RATES:
        ref_losses, port_losses = book_rate_losses(rate)
        print(f"{rate}: reference {ref_losses}\n  port {port_losses}")
