"""The port's performance plane (paddle_tpu_torch/obs/perf.py) on the CPU:
the counterpart of tests/test_perf_compile_log.py, test_perf_memory.py and
test_perf_attribute.py.

* compile telemetry: a noted build lands a ``paddle_tpu_compile_seconds``
  observation, a CompileRecord and a ``compile`` flight event; the ring is
  bounded; ``obs_compile_log=0`` turns the layer off; an engine's warmup
  lands one record per bucket (the first dispatch of each signature) and
  steady-state dispatches none;
* MemorySampler samples in the background and stretches its cadence with
  its own cost;
* ``attribute`` counts the FLOPs of one dispatch of an fc program and of a
  fused conv program, on both routes, equal to the analytic count (a
  multiply-add is two), and returns the reference's dict shape;
* ``profile`` aggregates a step callable's events and reports the kernel
  launches beside them.
"""

import json
import time

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.obs import perf
from paddle_tpu_torch.obs.metrics import REGISTRY
from paddle_tpu_torch.obs.recorder import RECORDER
from paddle_tpu_torch.serving import GenerationEngine, InferenceEngine
from paddle_tpu_torch.testing.models import resnet


@pytest.fixture(autouse=True)
def _fresh():
    perf.COMPILE_LOG.clear()
    RECORDER.clear()
    yield
    perf.COMPILE_LOG.clear()
    RECORDER.clear()
    set_flags({"obs_compile_log": 256, "kernel_tier": "auto"})


def _mlp(batch_dims=16, hidden=32, classes=4):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[batch_dims])
        h = fluid.layers.fc(x, hidden, act="relu")
        y = fluid.layers.fc(h, classes, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return main, exe, scope, y


def _save(tmp_path, main, exe, scope, feeds, fetch):
    d = str(tmp_path / "bundle")
    fluid.io.save_inference_model(d, feeds, fetch, exe, main, scope=scope)
    return d


def test_note_compile_lands_record_histogram_and_flight_event():
    hist = REGISTRY.get("paddle_tpu_compile_seconds")
    before = hist.labels(site="nvcc_build").snapshot()["count"]
    rec = perf.note_compile("nvcc_build", 1.5, identity={"kernel": "x"})
    assert rec.seq == 1 and rec.identity == {"kernel": "x"}
    assert hist.labels(site="nvcc_build").snapshot()["count"] == before + 1
    ev = [e for e in RECORDER.dump()["events"] if e["kind"] == "compile"]
    assert ev and ev[-1]["component"] == "nvcc_build"
    assert ev[-1]["detail"]["kernel"] == "x"
    json.dumps(rec.as_dict())
    with perf.compile_site("engine_warmup", bucket=4):
        assert perf.current_site() == ("engine_warmup", {"bucket": 4})
    assert perf.current_site() == ("jit_step", {})


def test_flag_off_disables_layer():
    set_flags({"obs_compile_log": 0})
    assert not perf.enabled()
    assert perf.note_compile("engine_warmup", 0.1) is None
    assert perf.COMPILE_LOG.stats()["count"] == 0


def test_compile_log_ring_bounded_and_stats():
    log = perf.CompileLog(capacity=3)
    for i in range(5):
        log.add(perf.CompileRecord("a" if i % 2 else "b", 0.5))
    assert len(log.records()) == 3
    st = log.stats()
    assert st["count"] == 5 and st["total_seconds"] == 2.5
    assert sum(s["count"] for s in st["by_site"].values()) == 3
    assert [r.site for r in log.records(site="a")] == ["a"]
    log.clear()
    assert log.stats()["count"] == 0


def test_engine_warmup_one_record_per_bucket(tmp_path):
    main, exe, scope, y = _mlp()
    d = _save(tmp_path, main, exe, scope, ["x"], [y])
    eng = InferenceEngine(d, place=fluid.CPUPlace(), buckets="1,2,4")
    assert eng.warmup() == 3
    recs = perf.COMPILE_LOG.records(site="engine_warmup")
    assert sorted(r.identity["bucket"] for r in recs) == [1, 2, 4]
    x = np.zeros((3, 16), np.float32)
    for _ in range(3):
        eng.infer({"x": x})
    assert perf.COMPILE_LOG.stats()["count"] == 3       # steady state: 0


def test_generation_engine_warmup_records(tmp_path):
    from paddle_tpu.testing.models import export_tiny_lm
    d = str(tmp_path / "lm")
    export_tiny_lm(d, vocab=17, emb=8, heads=2, n_layers=2, max_pos=64,
                   seed=3)
    eng = GenerationEngine(d, place=fluid.CPUPlace(), max_seqs=2,
                           block_size=4, num_blocks=32, max_len=16,
                           prefill_buckets=(8, 16))
    n = eng.warmup()
    recs = perf.COMPILE_LOG.records(site="genengine_warmup")
    assert len(recs) == n == 3
    assert {r.identity["phase"] for r in recs} == {"decode", "prefill"}


def test_memory_sampler_background_and_cost_bound(monkeypatch):
    s = perf.MemorySampler(interval_s=0.01).start()
    try:
        deadline = time.monotonic() + 5.0
        while s.samples < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert s.samples >= 3 and s.running()
    finally:
        assert s.stop()
    assert not s.running()
    out = s.sample_now()
    assert out["sources"]["cpu:0"] == "process_rss"
    # a slow sample stretches the cadence to cost_factor x its duration
    real = perf.sample_device_memory

    def slow():
        time.sleep(0.02)
        return real()
    monkeypatch.setattr(perf, "sample_device_memory", slow)
    s2 = perf.MemorySampler(interval_s=0.001, cost_factor=10.0)
    s2.sample_now()
    assert s2.stats()["effective_interval_s"] >= 0.2
    with pytest.raises(RuntimeError):
        s.start().start()
    s.stop()


def test_attribute_fc_program_flops_are_the_analytic_count(tmp_path):
    main, exe, scope, y = _mlp()
    feed = {"x": np.zeros((4, 16), np.float32)}
    res = perf.attribute(main, feed=feed, fetch_list=[y], executor=exe,
                         scope=scope, top=3, per_op=True)
    json.dumps(res)
    assert res["cost"]["flops"] == 2 * 4 * (16 * 32 + 32 * 4)
    assert res["cost"]["bytes_accessed"] > 0
    assert res["instructions"] == len(main.global_block().ops)
    assert len(res["rows"]) == 3
    assert res["rows"][0]["bytes"] >= res["rows"][-1]["bytes"]
    assert sum(r["flops"] for r in res["per_op"]) == res["cost"]["flops"]
    assert {"op", "kind", "flops", "bytes", "shape"} <= set(res["per_op"][0])
    assert perf.COMPILE_LOG.records(site="attribute")
    with pytest.raises(ValueError, match="feed"):
        perf.attribute(main)


def _conv_flops(program, batch):
    """2 x the multiply-adds of every conv and fc of ``program`` at
    ``batch`` rows, from its var shapes."""
    block = program.global_block()
    total = 0
    for op in block.ops:
        if op.type in ("conv2d", "fused_conv2d_bn"):
            w = block.var(op.input("Filter")[0]).shape
            out = block.var(op.output("Output")[0]).shape
            ho, wo = (out[1], out[2]) if op.attr("data_format") == "NHWC" \
                else (out[2], out[3])
            total += 2 * batch * ho * wo * w[0] * w[1] * w[2] * w[3]
        elif op.type == "mul":
            k, n = block.var(op.input("Y")[0]).shape
            total += 2 * batch * k * n
    return total


@pytest.mark.parametrize("tier", ["cuda", "torch"])
def test_attribute_conv_program_flops_are_the_analytic_count(tmp_path,
                                                             tier):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[16, 16, 3])
        logits = resnet(img, 10, counts=(1, 1, 1, 1), base=4)
    test = main.clone(for_test=True)
    fluid.fuse_conv_bn(test)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    d = _save(tmp_path, test, exe, scope, ["img"], [logits])
    set_flags({"kernel_tier": tier})
    eng = InferenceEngine(d, place=fluid.CPUPlace(), buckets=[2])
    res = perf.attribute(eng, batch=2, per_op=True)
    want = _conv_flops(eng.program, 2)
    assert any(op.type == "fused_conv2d_bn"
               for op in eng.program.global_block().ops)
    assert res["cost"]["flops"] == want
    by_kind = {}
    for r in res["per_op"]:
        by_kind[r["kind"]] = by_kind.get(r["kind"], 0) + r["flops"]
    assert by_kind["fused_conv2d_bn"] > 0
    res_dir = perf.attribute(d, batch=2, executor=exe)
    assert res_dir["cost"]["flops"] == want


def test_profile_any_step_callable():
    main, exe, scope, y = _mlp()
    feed = {"x": np.zeros((4, 16), np.float32)}
    res = perf.profile(lambda: exe.run(main, feed=feed, fetch_list=[y],
                                       scope=scope), steps=3, warmup=1)
    json.dumps(res)
    assert res["steps"] == 3 and not res["on_device"]
    assert res["wall_s_per_step"] > 0 and res["top"]
    assert res["launches"] == {} and res["complete"]
