"""The port's fluid.profiler (paddle_tpu_torch/fluid/profiler.py) on the
CPU: the reference's surface (profiler, start_profiler, stop_profiler,
reset_profiler; tests/test_profiler.py's eager cases) over the port's
host spans, and cuda_profiler's torch.profiler trace written as
chrome-tracing JSON (CPU activity here; CUDA activity on a card)."""

import io
import json

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core import profiler as core_prof


def _build():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        logits = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(logits, label))
        fluid.optimizer.SGD(0.1).minimize(loss, startup)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return main, exe, scope, loss


def _feed(rng):
    return {"x": rng.normal(0, 1, (8, 8)).astype("float32"),
            "label": rng.randint(0, 4, (8, 1)).astype("int64")}


@pytest.fixture(autouse=True)
def _idle():
    yield
    if core_prof.profiler_enabled():
        core_prof.disable_profiler()
    core_prof.reset_profiler()


def test_profiler_context_reports_ops_and_writes_chrome_json(tmp_path):
    main, exe, scope, loss = _build()
    rng = np.random.RandomState(0)
    out = io.StringIO()
    path = str(tmp_path / "trace.json")
    with fluid.profiler.profiler(sorted_key="total", profile_path=path,
                                 file=out):
        for _ in range(3):
            exe.run(main, feed=_feed(rng), fetch_list=[loss], scope=scope)
    report = out.getvalue()
    assert "Profiling Report" in report
    assert "mul" in report and "softmax" in report
    with open(path) as f:
        trace = json.load(f)
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"mul", "sgd", "softmax"} <= names
    # an sgd op for each of the 4 parameters a step
    assert sum(e["name"] == "sgd" for e in spans) == 3 * 4
    assert all(e["dur"] >= 1 for e in spans)


def test_start_stop_reset_and_sort_keys():
    main, exe, scope, loss = _build()
    rng = np.random.RandomState(1)
    fluid.profiler.start_profiler("CPU")
    exe.run(main, feed=_feed(rng), fetch_list=[loss], scope=scope)
    fluid.profiler.reset_profiler()
    assert core_prof.events() == []
    for _ in range(2):
        exe.run(main, feed=_feed(rng), fetch_list=[loss], scope=scope)
    rows = fluid.profiler.stop_profiler(sorted_key="calls",
                                        file=io.StringIO())
    byname = {r["name"]: r for r in rows}
    assert byname["mul"]["calls"] == 2 * 2      # 2 fc forwards a step
    assert byname["mul_grad"]["calls"] == 2 * 2
    assert [r["calls"] for r in rows] == sorted(
        (r["calls"] for r in rows), reverse=True)
    assert not core_prof.profiler_enabled()


def test_profiler_off_records_nothing():
    main, exe, scope, loss = _build()
    exe.run(main, feed=_feed(np.random.RandomState(2)), fetch_list=[loss],
            scope=scope)
    assert core_prof.events() == []


@pytest.mark.parametrize("target", ["trace.json", "logdir"])
def test_cuda_profiler_writes_a_chrome_trace(tmp_path, target):
    """On the CPU the trace holds the host's aten ops (a card adds its
    kernels); a path not ending in .json is a directory that receives
    trace.json. device_tracer is the same context."""
    main, exe, scope, loss = _build()
    rng = np.random.RandomState(3)
    exe.run(main, feed=_feed(rng), fetch_list=[loss], scope=scope)
    with fluid.profiler.cuda_profiler(str(tmp_path / target)) as prof:
        assert prof is not None
        exe.run(main, feed=_feed(rng), fetch_list=[loss], scope=scope)
    path = tmp_path / target
    if target == "logdir":
        path = path / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names, sorted(names)[:40]
    assert fluid.profiler.device_tracer is fluid.profiler.cuda_profiler
