"""The v2 trainer, inference and parameter surfaces in the port against
the reference's: v2.SGD's event stream and costs from one startup state
(1e-5 relative), test(), paddle.infer and Inference (chunked, by field,
through a feeding map), Parameters.to_tar and
Topology.serialize_for_inference loaded across the two packages with
equal inference, save_parameter_to_tar and fluid.io.save_params /
load_params directories read by the other package, the DetectionMAP and
pnpair evaluators, the networks and the v2.op math, the Ploter and the
master client. The port runs on the CPU only where asked: ``place=`` or
``paddle.init(use_gpu=False)``."""

import importlib
import io
import os
import tarfile

import numpy as np
import pytest
import torch

from torch_cross import (build_both, assert_same_program, jfluid, tfluid,
                         cross_losses, ref_state, port_scope)

import paddle_tpu.v2 as jv2
import paddle_tpu_torch.v2 as tv2
import paddle_tpu_torch.v2.inference as tinference

RTOL = 1e-5


def _pkg(fluid):
    return jv2 if fluid is jfluid else tv2


def _data(n=192, seed=0):
    w = np.random.RandomState(42).normal(0, 1, (16, 3))
    rng = np.random.RandomState(seed)
    xs = rng.normal(0, 1, (n, 16)).astype("float32")
    ys = (xs @ w).argmax(axis=1).astype("int64").reshape(-1, 1)
    return xs, [(xs[i], ys[i]) for i in range(n)]


def _reader(data, bs=32):
    return lambda: (data[i:i + bs] for i in range(0, len(data), bs))


def _build(paddle, fluid, place, metrics=False):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        pixel = paddle.layer.data("pixel_v2i",
                                  paddle.data_type.dense_vector(16))
        label = paddle.layer.data("label_v2i",
                                  paddle.data_type.integer_value(3))
        hidden = paddle.layer.fc(pixel, size=12,
                                 act=paddle.activation.Relu())
        pred = paddle.layer.fc(hidden, size=3,
                               act=paddle.activation.Softmax())
        cost = paddle.layer.classification_cost(input=pred, label=label)
        err = paddle.evaluator.classification_error(input=pred, label=label)
        params = paddle.parameters.create(cost)
        trainer = paddle.SGD(cost=cost, parameters=params,
                             update_equation=paddle.optimizer.Momentum(
                                 momentum=0.9, learning_rate=0.05),
                             feed_order=["pixel_v2i", "label_v2i"],
                             metrics={"err": err.var} if metrics else None,
                             main_program=main, startup_program=startup,
                             place=place)
    return trainer, params, pred


@pytest.fixture
def both():
    """The same trainer in both packages, the port's scope given the
    reference's startup values."""
    jt = _build(jv2, jfluid, jfluid.CPUPlace(), metrics=True)
    tt = _build(tv2, tfluid, tfluid.CPUPlace(), metrics=True)
    for p in jt[0]._main.all_parameters():
        tt[0].scope.set(p.name, torch.tensor(
            np.asarray(jt[0].scope.find_var(p.name))))
    return jt, tt


def _events(trainer, reader, passes=2):
    out = []

    def handler(evt):
        rec = [type(evt).__name__]
        if hasattr(evt, "cost"):
            rec.append(evt.cost)
        if type(evt).__name__ == "EndPass":
            rec.append(evt.metrics["cost"])
        out.append(rec)

    trainer.train(reader, num_passes=passes, event_handler=handler)
    return out


def test_event_stream_and_costs_match_the_reference(both):
    (jt, _, _), (tt, _, _) = both
    xs, data = _data()
    want = _events(jt, _reader(data))
    got = _events(tt, _reader(data))
    assert [e[0] for e in got] == [e[0] for e in want]
    assert got[0] == ["BeginPass"] and got[-1][0] == "EndPass"
    costs = [(g[1:], w[1:]) for g, w in zip(got, want) if len(w) > 1]
    np.testing.assert_allclose([c for g, _ in costs for c in g],
                               [c for _, w in costs for c in w], rtol=RTOL)
    # held-out evaluation: cost and the error metric
    _, held = _data(96, seed=1)
    tr, jr = tt.test(_reader(held)), jt.test(_reader(held))
    np.testing.assert_allclose(tr.cost, jr.cost, rtol=RTOL)
    np.testing.assert_allclose(tr.metrics["err"], jr.metrics["err"],
                               rtol=RTOL)
    first = next(w[1] for w in want if w[0] == "EndIteration")
    assert tr.cost < first             # it learned


def test_infer_matches_the_forward_and_the_reference(both):
    (jt, jp, jpred), (tt, tp, tpred) = both
    xs, data = _data()
    jt.train(_reader(data), num_passes=1)
    tt.train(_reader(data), num_passes=1)
    samples = [(x,) for x in xs[:10]]
    cpu = tfluid.CPUPlace()
    probs = tv2.infer(output_layer=tpred, parameters=tp, input=samples,
                      place=cpu)
    np.testing.assert_allclose(probs, jv2.infer(output_layer=jpred,
                                                parameters=jp,
                                                input=samples), rtol=RTOL,
                               atol=1e-6)
    direct = tfluid.Executor(cpu).run(
        tt._test_program, feed={"pixel_v2i": xs[:10],
                                "label_v2i": np.zeros((10, 1), "int64")},
        fetch_list=[tpred.var], scope=tt.scope)[0]
    np.testing.assert_array_equal(probs, direct)
    ids = tv2.infer(output_layer=tpred, parameters=tp, input=samples,
                    field="id", place=cpu)
    np.testing.assert_array_equal(ids, np.argmax(probs, axis=1))
    fed = tv2.infer(output_layer=tpred, parameters=tp,
                    input=[(0, x) for x in xs[:10]],
                    feeding={"pixel_v2i": 1}, place=cpu)
    np.testing.assert_array_equal(fed, probs)
    inferer = tv2.Inference(tp, output_layer=tpred, place=cpu)
    chunks = list(inferer.iter_infer(samples, batch_size=4))
    assert [np.asarray(c[0]).shape[0] for c in chunks] == [4, 4, 2]
    np.testing.assert_allclose(inferer.infer(input=samples, batch_size=4),
                               probs, rtol=RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="batch_size"):
        inferer.infer(input=samples, batch_size=0)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tar_and_topology_load_across_packages(both, writer):
    """One package's Parameters.to_tar and serialize_for_inference, loaded
    by the other's Parameters.from_tar_file and Inference(fileobj=), give
    the writer's inference."""
    (jt, jp, jpred), (tt, tp, tpred) = both
    xs, data = _data()
    jt.train(_reader(data), num_passes=1)
    tt.train(_reader(data), num_passes=1)
    samples = [(x,) for x in xs[:6]]
    cpu = tfluid.CPUPlace()
    if writer == "port":
        params, pred, paddle = tp, tpred, tv2
        want = tv2.infer(output_layer=tpred, parameters=tp, input=samples,
                         place=cpu)
        other, kw = jv2, {}
    else:
        params, pred, paddle = jp, jpred, jv2
        want = jv2.infer(output_layer=jpred, parameters=jp, input=samples)
        other, kw = tv2, {"place": cpu}
    topo = paddle.Topology(pred)
    topo_buf, par_buf = io.BytesIO(), io.BytesIO()
    topo.serialize_for_inference(topo_buf)
    params.to_tar(par_buf)
    loaded = other.parameters.Parameters.from_tar_file(
        io.BytesIO(par_buf.getvalue()))
    assert sorted(loaded.names()) == sorted(params.names())
    got = other.Inference(loaded, fileobj=io.BytesIO(topo_buf.getvalue()),
                          **kw).infer(input=samples)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert dict(other.Topology(
        tpred if other is tv2 else jpred).data_type())["pixel_v2i"].dim == 16


def test_tar_and_topology_bytes_equal_the_reference(both):
    """From one state, the port writes the reference's bytes: the same
    Parameters tar (one .npy member a parameter) and the same inference
    topology document."""
    (_, jp, jpred), (_, tp, tpred) = both
    out = []
    for paddle, params, pred in ((tv2, tp, tpred), (jv2, jp, jpred)):
        topo, tar = io.BytesIO(), io.BytesIO()
        paddle.Topology(pred).serialize_for_inference(topo)
        params.to_tar(tar)
        out.append((topo.getvalue(), tar.getvalue()))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]


def test_save_parameter_to_tar_and_save_params_cross_load(both, tmp_path):
    """save_parameter_to_tar's members (the .npy files and MANIFEST.json
    fluid.io.save_params writes) load through the reference's load_params,
    and the reference's save_params directory through the port's."""
    (jt, _, _), (tt, _, _) = both
    xs, data = _data()
    tt.train(_reader(data), num_passes=1)
    buf = io.BytesIO()
    tt.save_parameter_to_tar(buf)
    names = tarfile.open(fileobj=io.BytesIO(buf.getvalue())).getnames()
    assert "MANIFEST.json" in names
    d = tmp_path / "from_port"
    tarfile.open(fileobj=io.BytesIO(buf.getvalue())).extractall(
        d, filter="data")
    scope = jfluid.Scope()
    jfluid.io.load_params(jfluid.Executor(jfluid.CPUPlace()), str(d),
                          jt._main, scope=scope)
    for p in tt._main.all_parameters():
        np.testing.assert_array_equal(np.asarray(scope.find_var(p.name)),
                                      tt.scope.find_var(p.name).numpy())
    d2 = str(tmp_path / "from_reference")
    jfluid.io.save_params(jfluid.Executor(jfluid.CPUPlace()), d2, jt._main,
                          scope=jt.scope)
    tscope = tfluid.Scope()
    tfluid.io.load_params(tfluid.Executor(tfluid.CPUPlace()), d2, tt._main,
                          scope=tscope)
    for p in jt._main.all_parameters():
        np.testing.assert_array_equal(tscope.find_var(p.name).numpy(),
                                      np.asarray(jt.scope.find_var(p.name)))


@pytest.fixture
def init_reset():
    yield
    tinference._INIT.clear()


def test_the_card_is_the_default_and_init_asks_for_the_cpu(init_reset):
    """Without a place the trainer and the inferer take the card (here,
    without one, they raise: nothing falls back to the CPU on its own);
    paddle.init(use_gpu=False), or PADDLE_INIT_USE_GPU=0, asks for the
    CPU."""
    if torch.cuda.is_available():
        trainer = _build(tv2, tfluid, None)[0]
        assert trainer._exe.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CPUPlace"):
            _build(tv2, tfluid, None)
    args = tv2.init(use_gpu=False, trainer_count=1)
    assert args["use_gpu"] is False
    trainer, params, pred = _build(tv2, tfluid, None)
    assert trainer._exe.device.type == "cpu"
    xs, data = _data(64)
    trainer.train(_reader(data), num_passes=1)
    probs = tv2.infer(output_layer=pred, parameters=params,
                      input=[(x,) for x in xs[:4]])
    assert probs.shape == (4, 3)
    os.environ["PADDLE_INIT_USE_GPU"] = "0"
    try:
        tv2.init()
        assert tinference.default_place() is not None
    finally:
        del os.environ["PADDLE_INIT_USE_GPU"]


def test_parameters_set_get_and_from_tar_keep_the_device(both):
    (_, _, _), (tt, tp, _) = both
    name = tp.names()[0]
    before = tp.get(name).copy()
    buf = io.BytesIO()
    tp.to_tar(buf)
    tp.set(name, before + 1.0)
    assert isinstance(tt.scope.find_var(name), torch.Tensor)
    np.testing.assert_array_equal(tp.get(name), before + 1.0)
    buf.seek(0)
    tp.from_tar(buf)
    np.testing.assert_array_equal(tp.get(name), before)
    assert tp.shape(name) == before.shape


def _dets(lod_mod, rows, lens):
    if lod_mod == "port":
        from paddle_tpu_torch.core.lod import LoDArray
        return LoDArray(torch.tensor(rows), torch.tensor(lens,
                                                         dtype=torch.int32))
    import jax.numpy as jnp
    from paddle_tpu.core.lod import LoDArray
    return LoDArray(jnp.asarray(rows), jnp.asarray(lens, jnp.int32))


def test_detection_map_matches_the_reference():
    """Random detections over random ground truth, three classes, several
    batches: the same mAP, and the same per-detection TP flags."""
    rng = np.random.RandomState(3)
    evs = {"port": tfluid.evaluator.DetectionMAP(0.5),
           "ref": jfluid.evaluator.DetectionMAP(0.5)}
    for _ in range(4):
        gts, rows, lens = [], [], []
        for _ in range(3):
            boxes = rng.uniform(0, 0.6, (3, 2))
            gts.append([(int(rng.randint(0, 3)), b[0], b[1], b[0] + 0.3,
                         b[1] + 0.3) for b in boxes])
            k = int(rng.randint(1, 5))
            r = np.zeros((5, 6), "float32")
            for j in range(k):
                g = gts[-1][j % 3]
                shift = rng.uniform(-0.08, 0.08, 4)
                r[j] = [g[0] if rng.rand() < 0.8 else rng.randint(0, 3),
                        rng.rand(), *(np.array(g[1:]) + shift)]
            rows.append(r)
            lens.append(k)
        rows = np.stack(rows)
        for key, ev in evs.items():
            ev.update(_dets("port" if key == "port" else "ref", rows, lens),
                      gts)
    assert evs["port"].eval() == evs["ref"].eval()
    assert evs["port"]._dets == evs["ref"]._dets


def _evaluators(fluid):
    paddle = _pkg(fluid)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        score = paddle.layer.data("score", paddle.data_type.dense_vector(3))
        label = paddle.layer.data("label", paddle.data_type.integer_value(3))
        query = paddle.layer.data("query", paddle.data_type.integer_value(9))
        pred = paddle.layer.fc(score, size=3,
                               act=paddle.activation.Softmax())
        ev = paddle.evaluator
        outs = [ev.classification_error(pred, label),
                ev.pnpair(pred, label, query),
                ev.sum(pred), ev.column_sum(pred),
                ev.precision_recall(pred, label), ev.auc(pred, label)]
    return main, startup, outs


def test_evaluators_build_and_compute_as_the_reference():
    progs = build_both(_evaluators)
    assert_same_program(progs["port"][0], progs["ref"][0])
    rng = np.random.RandomState(8)
    feed = {"score": rng.normal(0, 1, (12, 3)).astype("float32"),
            "label": rng.randint(0, 3, (12, 1)).astype("int64"),
            "query": rng.randint(0, 3, (12, 1)).astype("int64")}
    fetch = [o.var.name for o in progs["ref"][2][:4]]
    jexe, jscope, state = ref_state(*progs["ref"][:2])
    want = jexe.run(progs["ref"][0], feed=feed, fetch_list=fetch,
                    scope=jscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        progs["port"][0], feed=feed, fetch_list=fetch,
        scope=port_scope(state))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=1e-6)


def _networks(fluid):
    paddle = _pkg(fluid)
    nets = paddle.networks
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = paddle.layer.data(
            "words", paddle.data_type.integer_value_sequence(30))
        emb = paddle.layer.embedding(words, size=8)
        conv = nets.sequence_conv_pool(emb, context_len=3, hidden_size=6)
        img = paddle.layer.data("img", paddle.data_type.dense_vector(48),
                                height=4, width=4)
        vgg = nets.img_conv_group(img, conv_num_filter=[4, 4],
                                  num_channels=3, pool_size=2, pool_stride=2,
                                  conv_with_batchnorm=True,
                                  conv_act=paddle.activation.Relu())
        e = paddle.op.exp(paddle.layer.fc(conv, size=4))
        out = paddle.layer.fc([e, vgg], size=2,
                              act=paddle.activation.Softmax())
        cost = paddle.layer.classification_cost(
            out, paddle.layer.data("label",
                                   paddle.data_type.integer_value(2)))
        fluid.optimizer.Adam(0.01).minimize(cost.var, startup)
    return main, startup, cost.var


def test_networks_and_op_math_train_as_the_reference():
    progs = build_both(_networks)
    assert_same_program(progs["port"][0], progs["ref"][0])
    rng = np.random.RandomState(9)
    feed = {"words": [rng.randint(0, 30, (int(n), 1)).astype("int64")
                      for n in (3, 6, 4, 5)],
            "img": rng.normal(0, 1, (4, 48)).astype("float32"),
            "label": rng.randint(0, 2, (4, 1)).astype("int64")}
    cross_losses(progs, feed, steps=5)


def test_v2_exports_the_reference_surface():
    for name in jv2.__all__:
        assert hasattr(tv2, name), name
    for mod in ("layer", "networks", "evaluator", "optimizer", "attr",
                "activation", "pooling", "data_type", "op", "event"):
        j = importlib.import_module(f"paddle_tpu.v2.{mod}")
        t = importlib.import_module(f"paddle_tpu_torch.v2.{mod}")
        public = [n for n in dir(j) if not n.startswith("_")
                  and not isinstance(getattr(j, n), type(np))]
        assert [n for n in public if not hasattr(t, n)] == [], mod
    assert tv2.batch is __import__("paddle_tpu_torch").reader.batch
    assert tv2.reader.__name__ == "paddle_tpu_torch.reader"
    assert tv2.dataset.__name__ == "paddle_tpu_torch.dataset"


def test_ploter_series_and_disable(tmp_path, monkeypatch):
    monkeypatch.setenv("DISABLE_PLOT", "True")
    from paddle_tpu_torch.v2.plot import Ploter
    p = Ploter("train cost", "test cost")
    p.append("train cost", 0, 1.5)
    p.append("train cost", 1, 1.2)
    p.append("test cost", 0, 1.7)
    assert getattr(p, "__plot_data__")["train cost"].value == [1.5, 1.2]
    p.plot()
    p.reset()
    assert getattr(p, "__plot_data__")["train cost"].step == []


def test_master_client_reads_recordio_chunks(tmp_path):
    """v2.master.client over the port's master service and recordio: every
    record of the dataset once a pass, and the save-model lease."""
    from paddle_tpu_torch.distributed.master import Master
    from paddle_tpu_torch.distributed.rpc import RpcServer
    from paddle_tpu_torch.recordio import write_records
    import paddle_tpu_torch.v2.master as vmaster

    paths = []
    for i in range(3):
        p = str(tmp_path / f"chunk{i}.recordio")
        write_records(p, [f"rec-{i}-{j}".encode() for j in range(4)])
        paths.append(p)
    rpc = RpcServer(Master(timeout_s=5.0))
    rpc.serve_in_thread()
    try:
        c = vmaster.client(f"127.0.0.1:{rpc.address[1]}")
        c.set_dataset(paths)
        c.paddle_start_get_records()
        got = []
        while True:
            r = c.next_record()
            if r is None:
                break
            got.append(bytes(r))
        assert sorted(got) == sorted(
            f"rec-{i}-{j}".encode() for i in range(3) for j in range(4))
        assert c.request_save_model("t0", 200) == 1
        assert c.request_save_model("t1", 200) == 0
        c.release()
    finally:
        rpc.shutdown()
