"""The port's ahead-of-time export (paddle_tpu_torch/fluid/aot.py) against
the reference's (paddle_tpu/fluid/aot.py), the counterparts of
tests/test_capi_aot.py's artifact cases, on the CPU.

Each model is built by both front ends; the port takes the reference's
state by name (trained there, where the reference test trains). Both
packages export an artifact of the same pruned program, and the artifacts
are held to each other on the same feeds within rtol 1e-5 / atol 1e-6
(float32 sums in another order). Under ``kernel_tier=cuda`` the port's
artifact holds the kernels' operators (``paddle_tpu_torch::lstm_seq``,
``::conv_affine``), whose CPU implementations are the plain versions, and
is held to the reference's Pallas route (interpret mode)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import aot as jaot
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import aot as taot
from paddle_tpu_torch.ops.cuda import rnn as trnn
from paddle_tpu_torch.testing.models import lstm_textcls, resnet

from torch_cross import build_both, port_scope, ref_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _tiers():
    yield
    jfluid.set_flags({"kernel_tier": "auto"})
    tfluid.set_flags({"kernel_tier": "auto"})


def _fc(fluid):
    """tests/test_capi_aot.py's small model: 8 -> 16 relu -> 4 softmax,
    SGD(0.1) on a cross-entropy loss."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 0
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        probs = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(probs, label))
        fluid.optimizer.SGD(0.1).minimize(loss, startup)
    return main, startup, probs


@pytest.fixture(scope="module")
def trained_fc():
    return _trained_fc()


def _trained_fc():
    """The fc model trained 30 steps in the reference (its test's loop);
    returns (reference main, exe, scope, probs; port main, probs, scope)."""
    progs = build_both(_fc)
    jmain, jstartup, jprobs = progs["ref"]
    jexe, jscope, _ = ref_state(jmain, jstartup, mode="eager")
    rng = np.random.RandomState(3)
    w = rng.normal(0, 1, (8, 4))
    for _ in range(30):
        x = rng.normal(0, 1, (32, 8)).astype("float32")
        y = np.argmax(x @ w, 1).astype("int64").reshape(-1, 1)
        jexe.run(jmain, feed={"x": x, "label": y}, scope=jscope)
    names = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and not v.is_data]
    state = {n: np.array(jscope.find_var(n)) for n in names
             if jscope.find_var(n) is not None}
    tmain, _, tprobs = progs["port"]
    return jmain, jexe, jscope, jprobs, tmain, tprobs, port_scope(state)


def _export_both(tmp_path, feeds, jargs, targs):
    """Each package's artifact of its (main, scope, target); returns the
    two loaded artifacts and the port's manifest."""
    jmain, jexe, jscope, jtarget = jargs
    tmain, tscope, ttarget = targs
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jaot.export_inference_artifact(jdir, feeds, [jtarget], jexe,
                                   main_program=jmain, scope=jscope)
    manifest = taot.export_inference_artifact(
        tdir, feeds, [ttarget], tfluid.Executor(tfluid.CPUPlace()),
        main_program=tmain, scope=tscope)
    return (jaot.load_inference_artifact(jdir),
            taot.load_inference_artifact(tdir), manifest)


def test_fc_artifact_matches_the_reference_artifact(tmp_path, trained_fc):
    """One artifact, batches 6 and 2 (the batch is a torch.export Dim:
    _align's rank rule keeps it symbolic through the fc's bias add)."""
    jmain, jexe, jscope, jprobs, tmain, tprobs, tscope = trained_fc
    jart, tart, manifest = _export_both(
        tmp_path, ["x"], (jmain, jexe, jscope, jprobs),
        (tmain, tscope, tprobs))
    assert manifest["format"] == taot.FORMAT == "torch.export.pt2.v1"
    assert manifest["device"] == "cpu"
    assert manifest["dims"] == {"b": [1, None], "b_len": [1, None]}
    assert set(manifest) >= {"feeds", "fetches", "batch_symbol", "format"}
    assert manifest["feeds"] == [{"name": "x", "shape": [-1, 8],
                                  "dtype": "float32", "lod_level": 0}]
    assert os.path.exists(tmp_path / "port" / taot.ARTIFACT_FILENAME)
    x = np.random.RandomState(9).normal(0, 1, (6, 8)).astype("float32")
    for n in (6, 2, 1):
        got, = tart.run({"x": x[:n]})
        want, = jart.run({"x": x[:n]})
        assert got.shape == (n, 4)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_fresh_interpreter_without_jax_gives_the_same_numbers(tmp_path,
                                                             trained_fc):
    jmain, jexe, jscope, jprobs, tmain, tprobs, tscope = trained_fc
    jart, tart, _ = _export_both(tmp_path, ["x"],
                                 (jmain, jexe, jscope, jprobs),
                                 (tmain, tscope, tprobs))
    x = np.random.RandomState(9).normal(0, 1, (6, 8)).astype("float32")
    np.save(tmp_path / "x.npy", x)
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from paddle_tpu_torch.fluid import aot\n"
        f"art = aot.load_inference_artifact({str(tmp_path / 'port')!r})\n"
        f"x = np.load({str(tmp_path / 'x.npy')!r})\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, art.run({{'x': x}})[0])\n"
        "print(json.dumps(sorted(m for m in ('jax', 'paddle_tpu') "
        "if m in sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    want, = jart.run({"x": x})
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"),
                               np.asarray(want), **TOL)


def _seq_pool(fluid):
    """tests/test_capi_aot.py's sequence model: embedding -> average
    pool -> softmax."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        emb = fluid.layers.embedding(words, size=(20, 8))
        pooled = fluid.layers.sequence_pool(emb, pool_type="average")
        probs = fluid.layers.fc(pooled, 3, act="softmax")
    return main, startup, probs


def _textcls(fluid):
    """bench.py:239's LSTM classifier at narrow widths (vocab 50, emb 8,
    two LSTMs of 16)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        probs = lstm_textcls(words, vocab=50, emb=8, hidden=16,
                             layers=fluid.layers)
    return main, startup, probs


def _ragged(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (int(n), 1)).astype("int64")
            for n in lens]


def _lod_artifacts(tmp_path, build):
    progs = build_both(build)
    jmain, jstartup, jprobs = progs["ref"]
    jexe, jscope, state = ref_state(jmain, jstartup, mode="eager")
    tmain, _, tprobs = progs["port"]
    return _export_both(tmp_path, ["words"], (jmain, jexe, jscope, jprobs),
                        (tmain, port_scope(state), tprobs))


@pytest.mark.parametrize("build, vocab", [(_seq_pool, 20), (_textcls, 50)],
                         ids=["seq_pool", "lstm_textcls"])
def test_lod_artifact_serves_other_batches_and_lengths(tmp_path, build,
                                                       vocab):
    """One artifact: batch 3 at padded length 7, batch 1 at 9, batch 5 at
    12 (the padded length is a second Dim; the plain scans run as
    operators, so the trace does not unroll them)."""
    jart, tart, manifest = _lod_artifacts(tmp_path, build)
    assert manifest["feeds"][0]["lod_level"] == 1
    assert manifest["dims"]["b_len"] == [1, None]
    if build is _textcls:
        code = tart._exported.graph_module.code
        assert code.count("paddle_tpu_torch.lstm_scan") == 2
        assert "paddle_tpu_torch.lstm_seq" not in code
    for i, lens in enumerate(((4, 7, 3), (9,), (2, 12, 5, 1, 6))):
        seqs = _ragged(vocab, lens, i)
        got, = tart.run({"words": seqs})
        want, = jart.run({"words": seqs})
        assert got.shape == (len(lens), got.shape[1])
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _fused_net(fluid):
    """A small fused conv-bn net: the narrow ResNet (stages 1,1,1,1, base
    8) over 16x16x3 images, 10 classes, softmax."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[16, 16, 3])
        probs = fluid.layers.softmax(resnet(img, 10, counts=(1, 1, 1, 1),
                                            base=8, layers=fluid.layers))
    return main, startup, probs


def _ref_forward(main, startup, probs, feed, route, fuse=False):
    """The reference's pruned forward on ``route``, jit-compiled whole:
    (its state, output)."""
    jfluid.set_flags({"kernel_tier": route})
    exe, scope, state = ref_state(main, startup)
    if fuse:
        jfluid.fuse_conv_bn(main)
    prog = jfluid.io._prune_program(main, list(feed), [probs.name])
    out = exe.run(prog, feed=feed, fetch_list=[probs.name], scope=scope)[0]
    return state, np.asarray(out)


def test_kernel_tier_artifacts_hold_the_kernel_operators(tmp_path):
    """Under kernel_tier=cuda the port's artifacts call
    torch.ops.paddle_tpu_torch.lstm_seq (twice) and ::conv_affine (13
    times, 4 convs on the plain chain) and match the reference's Pallas
    route on the same state."""
    tfluid.set_flags({"kernel_tier": "cuda"})
    progs = build_both(_textcls)
    seqs = _ragged(50, (4, 7, 3, 9), 5)
    state, want = _ref_forward(*progs["ref"], {"words": seqs}, "pallas")
    tmain, _, tprobs = progs["port"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    d = str(tmp_path / "lstm")
    manifest = taot.export_inference_artifact(
        d, ["words"], [tprobs], exe, main_program=tmain,
        scope=port_scope(state))
    assert manifest["dims"]["b"] == [1, trnn.MAX_BATCH]
    art = taot.load_inference_artifact(d)
    code = art._exported.graph_module.code
    assert code.count("paddle_tpu_torch.lstm_seq.default") == 2
    assert "lstm_scan" not in code
    np.testing.assert_allclose(art.run({"words": seqs})[0], want, **TOL)

    progs = build_both(_fused_net)
    x = np.random.RandomState(1).normal(0, 1, (3, 16, 16, 3)) \
        .astype("float32")
    state, want = _ref_forward(*progs["ref"], {"img": x}, "pallas",
                               fuse=True)
    tmain, _, tprobs = progs["port"]
    assert tfluid.fuse_conv_bn(tmain) == 17
    d = str(tmp_path / "convnet")
    taot.export_inference_artifact(d, ["img"], [tprobs], exe,
                                   main_program=tmain,
                                   scope=port_scope(state))
    art = taot.load_inference_artifact(d)
    code = art._exported.graph_module.code
    assert code.count("paddle_tpu_torch.conv_affine.default") == 13
    assert code.count("aten.conv2d.default") == 4
    # float32 through 17 convs summed in another order (the conv kernel's
    # plain version sums per tap): tests/test_torch_serving.py's limit
    for n in (3, 1):
        np.testing.assert_allclose(art.run({"img": x[:n]})[0], want[:n],
                                   rtol=1e-4, atol=1e-5)


def test_batch_over_the_recurrent_range_raises(tmp_path):
    """An artifact exported with the LSTM on its kernel route serves up to
    MAX_BATCH rows (a divergence by design: the reference serves any
    batch); one more raises, naming the range."""
    tfluid.set_flags({"kernel_tier": "cuda"})
    main, startup, probs = _textcls(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    d = str(tmp_path / "a")
    taot.export_inference_artifact(d, ["words"], [probs], exe,
                                   main_program=main, scope=scope)
    art = taot.load_inference_artifact(d)
    n = trnn.MAX_BATCH
    assert art.run({"words": _ragged(50, [3] * n, 0)})[0].shape == (n, 2)
    with pytest.raises(ValueError, match=rf"batch {n + 1} is outside .*"
                                         rf"\[1, {n}\]"):
        art.run({"words": _ragged(50, [3] * (n + 1), 0)})


def test_lod_level_2_is_refused(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        words = tfluid.layers.data("words", shape=[1], dtype="int64",
                                   lod_level=2)
        emb = tfluid.layers.embedding(words, size=(20, 4))
        out = tfluid.layers.sequence_pool(emb, pool_type="sum")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match="lod_level=2"):
        taot.export_inference_artifact(str(tmp_path / "a"), ["words"],
                                       [out], exe, main_program=main,
                                       scope=scope)
    assert not (tmp_path / "a").exists()


def test_a_card_artifact_does_not_fall_back_to_the_cpu(tmp_path):
    """The artifact runs on the device it was exported on: a manifest
    naming a card that is absent refuses to load."""
    main, startup, probs = _fc(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    d = tmp_path / "a"
    taot.export_inference_artifact(str(d), ["x"], [probs], exe,
                                   main_program=main, scope=scope)
    manifest = json.loads((d / taot.MANIFEST_FILENAME).read_text())
    manifest["device"] = "cuda:7"
    (d / taot.MANIFEST_FILENAME).write_text(json.dumps(manifest))
    import torch
    if torch.cuda.device_count() > 7:
        pytest.skip("this machine has a cuda:7")
    with pytest.raises(RuntimeError, match="cuda:7"):
        taot.load_inference_artifact(str(d))
