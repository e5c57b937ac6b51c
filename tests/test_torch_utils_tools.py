"""The port's utils/ against the reference's: dump_config prints the same
program text (and the same JSON with --binary), make_model_diagram the
same DOT graph, plotcurve parses the same points, show_pb prints either
package's saved bundle alike, checkpoint_compat permutes alike, and a
merge_v2_model artifact written by either package loads in the other
with equal inference (topology JSON and parameter tar only: the JAX
package's aot artifact has no counterpart)."""

import io
import json

import numpy as np
import pytest

from torch_cross import jfluid, tfluid

import paddle_tpu.utils as jutils
import paddle_tpu_torch.utils as tutils
import paddle_tpu.v2 as jv2
import paddle_tpu_torch.v2 as tv2

CONF = """
from paddle.trainer_config_helpers import *

settings(batch_size=16, learning_rate=0.01)
img = data_layer(name="img", size=64)
hidden = fc_layer(input=img, size=32, act=ReluActivation())
prob = fc_layer(input=hidden, size=10, act=SoftmaxActivation())
outputs(prob)
"""


@pytest.fixture
def conf(tmp_path):
    p = tmp_path / "conf.py"
    p.write_text(CONF)
    return str(p)


def _fresh(fluid):
    fluid.framework.reset_unique_name()


@pytest.mark.parametrize("whole", [False, True])
def test_dump_config_prints_the_reference_text(conf, whole):
    outs = []
    for fluid, utils in ((tfluid, tutils), (jfluid, jutils)):
        _fresh(fluid)
        out = io.StringIO()
        utils.dump_config.dump_config(conf, whole=whole, out=out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "op mul" in outs[0] and ("batch_size" in outs[0]) == whole


def test_dump_config_binary_is_the_reference_json(conf):
    docs = []
    for fluid, utils in ((tfluid, tutils), (jfluid, jutils)):
        _fresh(fluid)
        buf = io.BytesIO()
        utils.dump_config.dump_config(conf, binary=True, out=buf)
        docs.append(json.loads(buf.getvalue().decode()))
    assert docs[0] == docs[1]


def test_make_model_diagram_draws_the_reference_graph(conf, tmp_path):
    dots = []
    for fluid, utils, name in ((tfluid, tutils, "t"), (jfluid, jutils, "j")):
        _fresh(fluid)
        path = str(tmp_path / f"{name}.dot")
        dots.append(utils.make_model_diagram.make_diagram(conf, path))
        assert open(path).read() == dots[-1]
    assert dots[0] == dots[1] and dots[0].startswith("digraph")


def test_plotcurve_parses_like_the_reference(tmp_path):
    lines = [
        "I0101 trainer.cpp:100] Pass=0 Batch=20 Cost=2.5 AvgCost=2.31",
        "Pass 1, Batch 10, Cost 1.75",
        "noise line",
        "I0101 trainer.cpp:100] Pass=2 Batch=20 Cost=1.2 AvgCost=1.10",
    ]
    pts = tutils.plotcurve.parse_log(lines)
    assert pts == jutils.plotcurve.parse_log(lines) == \
        [(0, 2.31), (1, 1.75), (2, 1.10)]
    assert tutils.plotcurve.plotcurve(lines, str(tmp_path / "c.png")) == pts


def _bundle(fluid, path):
    _fresh(fluid)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        y = fluid.layers.fc(input=x, size=2, act=None)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(path, ["x"], [y], exe, main, scope=scope)


def test_show_pb_prints_either_bundle(tmp_path):
    docs = []
    for fluid, name in ((tfluid, "t"), (jfluid, "j")):
        _bundle(fluid, str(tmp_path / name))
    for utils in (tutils, jutils):
        for name in ("t", "j"):
            out = io.StringIO()
            doc = utils.show_pb.show(str(tmp_path / name), out)
            assert json.loads(out.getvalue()) == doc
            docs.append(doc)
    assert all(d == docs[0] for d in docs)


def test_checkpoint_compat_permutes_like_the_reference():
    rng = np.random.RandomState(4)
    w = rng.normal(0, 1, (6, 4 * 5)).astype("float32")
    b = rng.normal(0, 1, (1, 7 * 5)).astype("float32")
    for inverse in (False, True):
        np.testing.assert_array_equal(
            tutils.convert_reference_lstm_weight(w, inverse=inverse),
            jutils.convert_reference_lstm_weight(w, inverse=inverse))
        for peep in (False, True):
            bb = b if peep else b[:, :20]
            np.testing.assert_array_equal(
                tutils.convert_reference_lstm_bias(bb, peepholes=peep,
                                                   inverse=inverse),
                jutils.convert_reference_lstm_bias(bb, peepholes=peep,
                                                   inverse=inverse))
    back = tutils.convert_reference_lstm_weight(
        tutils.convert_reference_lstm_weight(w), inverse=True)
    np.testing.assert_array_equal(back, w)


def _parsed(fluid, ch, conf):
    _fresh(fluid)
    topo, main, startup = ch.parse_config(conf)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return topo, main, scope


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_merged_model_loads_in_the_other_package(conf, tmp_path, writer):
    """merge_v2_model by one package (a parsed config's topology and its
    Parameters tar); load_merged_model by the other, its parameters
    through Parameters.from_tar_file and its topology through
    Inference(fileobj=): the writer's own inference."""
    import paddle_tpu.v2.config_helpers as jch
    import paddle_tpu_torch.v2.config_helpers as tch
    side = {"port": (tfluid, tch, tv2, tutils, {"place": tfluid.CPUPlace()}),
            "reference": (jfluid, jch, jv2, jutils, {})}
    fluid, ch, v2, utils, kw = side[writer]
    _, _, ov2, outils, okw = side[
        "reference" if writer == "port" else "port"]
    topo, main, scope = _parsed(fluid, ch, conf)
    params = v2.parameters.Parameters(main, scope)
    tar_path = str(tmp_path / "params.tar")
    with open(tar_path, "wb") as f:
        params.to_tar(f)
    merged = str(tmp_path / "merged.paddle")
    utils.merge_v2_model(topo, tar_path, merged)
    x = np.random.RandomState(6).normal(0, 1, (5, 64)).astype("float32")
    samples = [(r,) for r in x]
    want = v2.Inference(params, output_layer=topo.outputs[-1], **kw) \
        .infer(input=samples)

    topo_doc, param_bytes = outils.load_merged_model(merged)
    assert topo_doc["fetch_var_names"] == [topo.outputs[-1].var.name]
    restored = ov2.parameters.Parameters.from_tar_file(
        io.BytesIO(param_bytes))
    for name in params.names():
        np.testing.assert_array_equal(restored.get(name), params.get(name))
    got = ov2.Inference(restored, fileobj=io.BytesIO(
        json.dumps(topo_doc).encode()), **okw).infer(input=samples)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert isinstance(want, np.ndarray) and want.shape == (5, 10)

