"""The book chapters (tests/book/) in the port against the reference.

Parity: each chapter's model, built by both front ends at narrow widths
from ``paddle_tpu_torch.testing.models``, the port given the reference's
startup state, five steps on one seeded synthetic batch: the losses within
1e-4 relative at every step, every step-1 parameter gradient within 1e-4
of its largest element; SRL's per-sequence CRF cost too, and its Viterbi
paths exactly. A bias added just before a training-mode batch_norm has a
gradient of 0 in exact arithmetic (the mean subtraction cancels it), so
both packages give rounding noise there: it is held to 1e-4 of the
chapter's largest gradient element. vgg16_bn_drop runs with every
dropout rate 0 (the packages draw their masks from different generators;
a rate-0 mask keeps every element in both).

Contracts: each chapter's reference test from tests/book, run with the
port's fluid in place of the reference's (its synthetic data from
paddle_tpu.dataset's generators, nothing downloaded), under the port's
verify_passes and executor_verify as tests/book/conftest.py runs the
reference's: MNIST's MLP, CIFAR's ResNet and VGG, the inference round
trip (batch_norm with is_test after loading), both sentiment nets, SRL
with its decode and chunk F1, and the recommender.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

from torch_cross import build_both, ref_state, port_scope
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.testing import models as M

STEPS = 5
LOSS_RTOL = 1e-4
GRAD_REL = 1e-4

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


def _run(exe, main, scope, feed, fetch):
    """STEPS runs with one fetch list (the reference compiles one step)."""
    return [[_host(v) for v in exe.run(main, feed=feed, scope=scope,
                                       fetch_list=fetch)]
            for _ in range(STEPS)]


@pytest.mark.parametrize("chapter", sorted(CHAPTERS))
def test_chapter_trains_like_the_reference(chapter):
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
    want = _run(jexe, jmain, jscope, feed, fetch + grads)
    got = _run(tfluid.Executor(tfluid.CPUPlace()), tmain, port_scope(state),
               feed, fetch + grads)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], rtol=LOSS_RTOL,
                                   err_msg=f"{chapter} loss, step {step}")
        if chapter == "srl":
            np.testing.assert_allclose(g[1], w[1], rtol=LOSS_RTOL,
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
        assert np.max(np.abs(g - w)) <= GRAD_REL * scale, (
            chapter, name, float(np.max(np.abs(g - w))), scale)
    losses = [float(s[0]) for s in got]
    assert losses[-1] < losses[0], (chapter, losses)


BOOK = pathlib.Path(__file__).resolve().parent / "book"


def _book_module(name):
    spec = importlib.util.spec_from_file_location(f"_port_book_{name}",
                                                  BOOK / f"{name}.py")
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


@pytest.mark.parametrize("module,test,kwargs", CONTRACTS,
                         ids=[f"{t}-{k.get('net', '')}".rstrip("-")
                              for _, t, k in CONTRACTS])
def test_book_contract_on_the_port(port_book, tmp_path, module, test,
                                   kwargs):
    fn = getattr(port_book(module), test)
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    fn(**kwargs)
