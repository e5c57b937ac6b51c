"""The port's observability plane (paddle_tpu_torch/core/profiler.py,
paddle_tpu_torch/obs/) held to the reference's (paddle_tpu/core/profiler.py,
paddle_tpu/obs/).

The parts of tests/test_profiler.py, tests/test_flight_recorder.py,
tests/test_slo_engine.py and the registry that cover the ported functions:
each runs the same calls on both packages (``pkg``) and compares the
results, where they are deterministic, across the packages. The port's own:
``obs.perf``'s memory sample names its source and invents no number, and an
incident bundle links one request's events across a port client and a
reference server.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest

import paddle_tpu.core.profiler as jprof
import paddle_tpu.distributed.rpc as jrpc
import paddle_tpu.obs.metrics as jmetrics
import paddle_tpu.obs.recorder as jrec
import paddle_tpu.obs.slo as jslo
import paddle_tpu_torch.core.profiler as tprof
import paddle_tpu_torch.distributed.rpc as trpc
import paddle_tpu_torch.obs.metrics as tmetrics
import paddle_tpu_torch.obs.recorder as trec
import paddle_tpu_torch.obs.slo as tslo
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.obs import perf as tperf

WAIT_S = 5.0
PKGS = {
    "port": types.SimpleNamespace(prof=tprof, metrics=tmetrics, rec=trec,
                                  slo=tslo, rpc=trpc),
    "reference": types.SimpleNamespace(prof=jprof, metrics=jmetrics,
                                       rec=jrec, slo=jslo, rpc=jrpc),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _both(fn):
    """fn(pkg) on both packages: (port result, reference result)."""
    return fn(PKGS["port"]), fn(PKGS["reference"])


# ---------------------------------------------------------------------------
# profiler: spans, LatencyWindow, chrome export (test_profiler.py)
# ---------------------------------------------------------------------------

def test_latency_window_edges_agree_across_packages():
    def run(p):
        out = []
        w = p.prof.LatencyWindow(capacity=8)
        out.append(w.snapshot())
        out.append(w.percentiles((50, 90, 99)))
        w.record(0.004)
        out.append(w.snapshot())
        w2 = p.prof.LatencyWindow(capacity=8)
        for ms in range(24):               # two laps past the capacity
            w2.record(ms / 1e3)
            out.append(w2.snapshot())
        out.append(w2.percentiles((0, 50, 100)))
        w2.reset()
        out.append(w2.snapshot())
        out.append(p.prof.percentile([3.0, 1.0, 2.0, 10.0], 75))
        return out

    port, ref = _both(run)
    assert port == ref
    assert port[0] == {"count": 0, "window": 0, "p50_ms": 0.0,
                       "p99_ms": 0.0}
    np.testing.assert_allclose(port[-3][50], np.percentile(
        np.arange(16, 24), 50), rtol=1e-6)


def test_profiler_spans_summary_and_chrome_export(tmp_path, pkg):
    prof = pkg.prof
    prof.enable_profiler()
    try:
        with prof.trace_context("abcdabcdabcdabcd"):
            with prof.record_event("outer", kind="stage"):
                with prof.record_event("inner"):
                    pass
        with prof.record_event("inner"):
            pass
        w = prof.LatencyWindow(name="serving/request", kind="rpc")
        with w.span():
            pass
    finally:
        path = str(tmp_path / "trace.json")
        rows = prof.disable_profiler(sorted_key="calls", profile_path=path)
    by = {r["name"]: r for r in rows}
    assert by["inner"]["calls"] == 2 and by["outer"]["calls"] == 1
    assert by["serving/request"]["calls"] == 1 and w.count == 1
    assert rows[0]["name"] == "inner"              # most calls first
    with open(path) as f:
        doc = json.load(f)
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in evs} == {"outer", "inner", "serving/request"}
    traced = [e for e in evs if e["args"]]
    assert {e["args"]["trace_id"] for e in traced} == {"abcdabcdabcdabcd"}
    assert {e["name"] for e in traced} == {"outer", "inner"}
    assert doc["otherData"]["epoch_origin_us"] > 0
    # off: nothing is recorded
    with prof.record_event("ghost"):
        pass
    assert not any(e[1] == "ghost" for e in prof.events())


def test_trace_context_nesting_and_ids(pkg):
    prof = pkg.prof
    assert prof.current_trace_id() is None
    with prof.trace_context() as outer:
        assert len(outer) == 16 and prof.current_trace_id() == outer
        with prof.trace_context() as inner:
            assert inner == outer            # reuses the active id
        with prof.trace_context("0000111122223333") as given:
            assert given == prof.current_trace_id() == "0000111122223333"
        assert prof.current_trace_id() == outer
        tok = prof.set_trace_id("feedfeedfeedfeed")
        assert prof.current_trace_id() == "feedfeedfeedfeed"
        prof.reset_trace_id(tok)
        assert prof.current_trace_id() == outer
    assert prof.current_trace_id() is None


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_json_safe_agrees_across_packages_and_stringifies_torch():
    import torch
    obj = {np.int64(3): np.float32(1.5), "a": np.arange(3),
           "b": (1, np.bool_(True), {"c": {2, 1}}), "d": b"xy",
           "e": None, 5: [np.float64(2.0), "s"]}
    port, ref = _both(lambda p: p.metrics.json_safe(obj))
    assert port == ref
    json.dumps(port)
    # torch objects leave as builtins: a device as its string, a size as a
    # list (a tuple), a dtype as its string
    got = tmetrics.json_safe({"dev": torch.device("cuda", 0),
                              "size": torch.Size([2, 3]),
                              "dt": torch.float32})
    assert got == {"dev": "cuda:0", "size": [2, 3], "dt": "torch.float32"}


def test_registry_families_snapshot_and_prometheus_agree():
    def run(p):
        reg = p.metrics.MetricsRegistry()
        c = reg.counter("paddle_tpu_test_reqs", "requests",
                        labels=("instance",))
        g = reg.gauge("paddle_tpu_test_depth", "depth")
        h = reg.histogram("paddle_tpu_test_lat", "latency",
                          labels=("route",), window=16)
        c.labels(instance="a").inc()
        c.labels(instance="a").inc(2)
        c.labels(instance="b").inc()
        g.child().set(7)
        g.child().dec(2)
        for ms in (1, 2, 3, 40):
            h.labels(route="x").observe(ms / 1e3)
        with pytest.raises(ValueError):
            reg.counter("Bad-Name")
        with pytest.raises(ValueError):
            c.labels(wrong="a")
        snap = reg.snapshot()
        return (snap, reg.totals(), p.metrics.prometheus_text(snap),
                p.metrics.merge_snapshots([snap, snap]), sorted(reg.names()))

    port, ref = _both(run)
    assert port == ref
    snap, totals, prom, merged, names = port
    assert totals["paddle_tpu_test_reqs"] == 4
    assert 'paddle_tpu_test_reqs{instance="a"} 3' in prom
    assert "paddle_tpu_test_lat_count" in prom
    assert names == ["paddle_tpu_test_depth", "paddle_tpu_test_lat",
                     "paddle_tpu_test_reqs"]


def test_next_instance_and_the_process_registry(pkg):
    a, b = pkg.metrics.next_instance("engine"), \
        pkg.metrics.next_instance("engine")
    assert a.startswith("engine-") and a != b
    fam = pkg.metrics.REGISTRY.get("paddle_tpu_flight_events")
    base = fam.labels(kind="counter_probe").value
    pkg.rec.record("counter_probe")
    assert fam.labels(kind="counter_probe").value == base + 1


# ---------------------------------------------------------------------------
# flight recorder (test_flight_recorder.py)
# ---------------------------------------------------------------------------

def test_ring_bounds_fields_and_dropped_count(pkg):
    r = pkg.rec.FlightRecorder(capacity=4)
    for i in range(7):
        r.record("k", component="c", i=i)
    evs = r.events()
    assert [e["detail"]["i"] for e in evs] == [3, 4, 5, 6]   # oldest gone
    assert [e["seq"] for e in evs] == [4, 5, 6, 7]           # monotonic
    ev = evs[-1]
    assert ev["kind"] == "k" and ev["component"] == "c"
    assert ev["trace"] is None and isinstance(ev["t"], float)
    d = r.dump()
    assert d["dropped"] == 3 and d["capacity"] == 4
    assert d["pid"] == os.getpid()
    json.dumps(d)
    r.record("other")
    assert [e["kind"] for e in r.events(kinds={"other"})] == ["other"]
    r.clear()
    assert r.events() == [] and r.dump()["dropped"] == 0


def test_events_stamp_the_trace_id_and_coerce_detail(pkg):
    r = pkg.rec.FlightRecorder(capacity=8)
    with pkg.prof.trace_context() as tid:
        r.record("traced", arr=np.arange(2), n=np.int64(3))
    r.record("untraced")
    evs = r.events()
    assert evs[0]["trace"] == tid and evs[1]["trace"] is None
    assert evs[0]["detail"] == {"arr": [0, 1], "n": 3}
    json.dumps(evs)


def test_ring_concurrent_writers_exact_seq(pkg):
    r = pkg.rec.FlightRecorder(capacity=10000)
    n, t = 500, 4

    def w():
        for _ in range(n):
            r.record("hammer")

    ts = [threading.Thread(target=w) for _ in range(t)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(WAIT_S)
    assert {e["seq"] for e in r.events()} == set(range(1, n * t + 1))


def test_flight_capacity_follows_the_flag():
    assert tflags.get_flag("obs_flight_events") == 2048
    assert trec.FlightRecorder().dump()["capacity"] == 2048


def test_builtin_flight_dump_rpc_and_handler_override():
    class Handler:
        def ping(self):
            trec.record("server_ping", component="test_handler")
            return True

    srv = trpc.RpcServer(Handler())
    srv.serve_in_thread()
    c = trpc.RpcClient(srv.address)
    try:
        c.call("ping")
        d = c.call("flight_dump")
        assert d["pid"] == os.getpid()
        assert any(e["kind"] == "server_ping" for e in d["events"])
    finally:
        c.close()
        srv.shutdown()

    class Own:
        def flight_dump(self):
            return {"custom": True}

    srv = trpc.RpcServer(Own())
    srv.serve_in_thread()
    c = trpc.RpcClient(srv.address)
    try:
        assert c.call("flight_dump") == {"custom": True}   # handler wins
    finally:
        c.close()
        srv.shutdown()


def test_capture_bundle_links_a_request_across_packages():
    """A port client's request into a reference server leaves recorder
    events in both rings under one trace id; the port's bundle merges them
    and lists the id under linked_traces."""
    class Marker:
        def mark(self, label):
            jrec.record("child_mark", component="ref_server", label=label)
            return os.getpid()

    srv = jrpc.RpcServer(Marker())
    srv.serve_in_thread()
    try:
        trec.RECORDER.clear()
        c = trpc.RpcClient(srv.address)
        with tprof.trace_context() as tid:
            trec.record("parent_mark", component="port_client")
            c.call("mark", label="x")
        c.close()
        bundle = trec.capture_bundle([srv.address], reason="test")
        assert tid in bundle["linked_traces"]
        linked = sorted((e["t"], e["source"], e["kind"])
                        for e in bundle["events"] if e.get("trace") == tid)
        assert [k for _, _, k in linked] == ["parent_mark", "child_mark"]
        assert linked[0][1] == "local" and linked[1][1] != "local"
        assert bundle["unreachable"] == []
        json.dumps(bundle)
        docs, labels = trec.bundle_to_chrome(bundle)
        assert len(docs) == 2 and all(
            d["otherData"]["epoch_origin_us"] > 0 for d in docs)
    finally:
        srv.shutdown()


def test_incident_collector_trigger_cooldown_and_disk(tmp_path, pkg):
    out_dir = str(tmp_path / "incidents")
    col = pkg.rec.IncidentCollector(addresses=[], out_dir=out_dir,
                                    cooldown_s=30.0, keep=4)
    pkg.rec.record("incident_seed", component="test")
    assert col.trigger("manual") is True
    assert col.trigger("manual") is False        # cooldown suppresses
    assert col.wait_idle(WAIT_S)
    st = col.stats()
    assert st["captures"] == 1 and st["suppressed"] == 1
    files = os.listdir(out_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(out_dir, files[0])) as f:
        bundle = json.load(f)
    assert bundle["reason"] == "manual"
    assert any(e["kind"] == "incident_seed" for e in bundle["events"])
    col2 = pkg.rec.IncidentCollector(addresses=[], cooldown_s=0.0)
    f = pkg.slo.SloBreach("r", time.time(), 2.0, 1.0, 2.0, {"1s": 2.0})
    assert col2.trigger(f) is True
    assert col2.wait_idle(WAIT_S)
    assert col2.bundles[-1]["reason"] == "breach"
    assert col2.bundles[-1]["detail"]["rule"] == "r"


# ---------------------------------------------------------------------------
# SLO rules and monitor (test_slo_engine.py)
# ---------------------------------------------------------------------------

def _gauge_snapshot(name, by_instance):
    return {name: {
        "type": "gauge", "help": "", "labels": ["instance"],
        "values": [{"labels": {"instance": k}, "value": v}
                   for k, v in by_instance.items()]}}


def _hist_snapshot(name, values):
    durs = sorted(values)
    return {name: {
        "type": "histogram", "help": "", "labels": ["instance"],
        "values": [{"labels": {"instance": "i1"}, "count": len(durs),
                    "window": len(durs), "p50_ms": durs[len(durs) // 2],
                    "p99_ms": durs[-1], "max_ms": durs[-1]}]}}


def test_rule_validation_and_dict_round_trip(pkg):
    SloRule, SloMonitor = pkg.slo.SloRule, pkg.slo.SloMonitor
    r = SloRule("p99", "paddle_tpu_serving_request_seconds", 50.0,
                reducer="p99_ms", labels={"instance": "x"},
                windows=((5.0, 1.0), (60.0, 0.5)), description="d")
    assert SloRule.from_dict(r.to_dict()).to_dict() == r.to_dict()
    json.dumps(r.to_dict())
    for kw, match in (({"objective": 0.0}, "objective"),
                      ({"reducer": "p42_ms"}, "reducer"),
                      ({"agg": "median"}, "agg"),
                      ({"windows": ()}, "at least"),
                      ({"windows": ((0.0, 1.0),)}, "window")):
        args = dict({"objective": 1.0}, **kw)
        with pytest.raises(ValueError, match=match):
            SloRule("bad", "m", **args)
    with pytest.raises(ValueError, match="unknown fields"):
        SloRule.from_dict({"name": "x", "metric": "m", "objective": 1.0,
                           "bogus": 1})
    with pytest.raises(ValueError, match="duplicate"):
        SloMonitor([SloRule("a", "m", 1.0), SloRule("a", "m", 2.0)])


def test_rule_dicts_cross_packages():
    """A rule's dict form from one package builds the same rule in the
    other (rules travel as plain data)."""
    r = tslo.SloRule("lat", "paddle_tpu_serving_request_seconds", 25.0,
                     labels={"instance": "server-1"}, agg="sum",
                     windows=((2.0, 1.5),))
    assert jslo.SloRule.from_dict(r.to_dict()).to_dict() == r.to_dict()


def test_rule_measure_reducers_selectors_and_agg(pkg):
    SloRule = pkg.slo.SloRule
    snap = _gauge_snapshot("paddle_tpu_test_slo_depth", {"a": 3.0, "b": 7.0})
    assert SloRule("d", "paddle_tpu_test_slo_depth", 5.0,
                   reducer="value").measure(snap) == 7.0
    assert SloRule("d", "paddle_tpu_test_slo_depth", 5.0, reducer="value",
                   agg="sum").measure(snap) == 10.0
    sel = SloRule("d", "paddle_tpu_test_slo_depth", 5.0, reducer="value",
                  labels={"instance": "a"})
    assert sel.measure(snap) == 3.0
    assert sel.measure({}) is None
    h = _hist_snapshot("paddle_tpu_test_slo_lat", [1.0, 2.0, 40.0])
    assert SloRule("l", "paddle_tpu_test_slo_lat", 10.0,
                   reducer="p99_ms").measure(h) == 40.0


def test_burn_rate_evaluations_agree_across_packages():
    """The same snapshots at the same instants give the same verdicts in
    both packages: a single-window breach, recovery and re-arm; a spike
    the long window must not breach on; a counter rate with a reset."""
    ok = _gauge_snapshot("paddle_tpu_test_slo_depth", {"a": 2.0})
    hot = _gauge_snapshot("paddle_tpu_test_slo_depth", {"a": 8.0})
    cool = _hist_snapshot("paddle_tpu_test_slo_lat", [1.0])
    spike = _hist_snapshot("paddle_tpu_test_slo_lat", [100.0])

    def errs(v):
        return {"paddle_tpu_test_slo_errs": {
            "type": "counter", "help": "", "labels": [],
            "values": [{"labels": {}, "value": v}]}}

    def run(p):
        R, M = p.slo.SloRule, p.slo.SloMonitor
        out = []
        mon = M([R("depth", "paddle_tpu_test_slo_depth", 4.0,
                   reducer="value", windows=((1.0, 1.0),))],
                emit_metrics=False)
        for snap, now in ((ok, 100.0), (hot, 101.5), (hot, 101.6),
                          (ok, 103.0), (hot, 105.0)):
            out.append(mon.evaluate_once(snap, now=now))
        # findings carry the wall clock of their evaluation: all but "t"
        out.append([{k: v for k, v in f.as_dict().items() if k != "t"}
                    for f in mon.findings()])
        mon = M([R("lat", "paddle_tpu_test_slo_lat", 10.0,
                   windows=((1.0, 1.0), (60.0, 1.0)))], emit_metrics=False)
        for i in range(30):
            mon.evaluate_once(cool, now=1000.0 + i)
        for i in range(30, 71):
            out.append(mon.evaluate_once(spike, now=1000.0 + i))
        mon = M([R("errs", "paddle_tpu_test_slo_errs", 5.0, reducer="rate",
                   windows=((10.0, 1.0),))], emit_metrics=False)
        for v, now in ((100, 10.0), (120, 12.0), (5, 14.0)):
            out.append(mon.evaluate_once(errs(v), now=now))
        return out

    port, ref = _both(run)
    assert port == ref
    assert port[1]["depth"]["breaches"] == 1 and not port[1]["depth"]["ok"]
    assert port[4]["depth"]["breaches"] == 2
    assert port[6]["lat"]["ok"]                 # one spike: no breach
    assert not port[46]["lat"]["ok"]            # sustained: breach
    assert port[-2]["errs"]["value"] == pytest.approx(10.0)
    assert port[-1]["errs"]["value"] == 0.0     # a reset clamps to 0


def test_background_monitor_emits_series_and_findings():
    fam = tmetrics.REGISTRY.gauge("paddle_tpu_test_slo_bg",
                                  labels=("instance",))
    fam.labels(instance="x").set(50.0)
    fired = []
    mon = tslo.SloMonitor([tslo.SloRule("bg", "paddle_tpu_test_slo_bg",
                                        10.0, reducer="value",
                                        windows=((0.5, 1.0),))],
                          interval_s=0.05, on_breach=fired.append)
    mon.start()
    try:
        tick = threading.Event()
        deadline = time.monotonic() + WAIT_S
        while mon.breach_count() == 0 and time.monotonic() < deadline:
            tick.wait(0.01)
        assert mon.breach_count() == 1
        hs = mon.health_section()
        assert hs["ok"] is False and hs["evaluations"] >= 1
        assert hs["recent_breaches"][-1]["rule"] == "bg"
        json.dumps(hs)
        burn = tmetrics.REGISTRY.get("paddle_tpu_slo_burn_rate")
        assert burn.labels(rule="bg", window="0.5s").value \
            == pytest.approx(5.0)
        assert len(fired) == 1 and fired[0].rule == "bg"
    finally:
        mon.stop()
    assert not mon.running()


def test_install_surface(pkg):
    assert pkg.slo.health_section() is None or pkg.slo.installed()
    mon = pkg.slo.SloMonitor([pkg.slo.SloRule("x", "m", 1.0)],
                             emit_metrics=False)
    prev = pkg.slo.installed()
    try:
        assert mon.install() is mon and pkg.slo.installed() is mon
        assert pkg.slo.health_section()["ok"] is True
    finally:
        pkg.slo.install(prev)


# ---------------------------------------------------------------------------
# obs.perf memory sample (the port's own)
# ---------------------------------------------------------------------------

def test_memory_sample_names_its_source_and_sets_the_gauges():
    s = tperf.sample_device_memory()
    assert set(s) == {"devices", "peaks", "sources", "total"}
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        pytest.skip("a CUDA card is in use: the allocator's numbers apply")
    # on the CPU: the process's resident set, read from /proc, and its peak
    assert s["sources"] == {"cpu:0": "process_rss"}
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    rss = pages * os.sysconf("SC_PAGE_SIZE")
    assert abs(s["devices"]["cpu:0"] - rss) < 64 * 2 ** 20
    assert s["peaks"]["cpu:0"] >= s["devices"]["cpu:0"] > 0
    assert s["total"] == s["devices"]["cpu:0"]
    live = tmetrics.REGISTRY.get("paddle_tpu_device_bytes_live")
    assert live.labels(device="cpu:0").value == s["devices"]["cpu:0"]
    sec = tperf.memory_section()
    # the reference's keys, builtins only
    assert set(sec) == {"device_bytes_live", "device_bytes_peak",
                        "sources", "total_bytes_live"}
    json.dumps(sec)


def test_memory_sample_makes_up_nothing_where_nothing_reads(monkeypatch):
    monkeypatch.setattr(tperf, "_process_rss", lambda: (None, None))
    monkeypatch.setattr(tperf, "_cuda_devices", lambda: (None, []))
    s = tperf.sample_device_memory()
    assert s == {"devices": {}, "peaks": {}, "sources": {}, "total": 0}


def test_memory_sample_reads_the_allocator_per_card(monkeypatch):
    """The card branch, with torch.cuda's readings stood in: one entry per
    initialised card, from memory_allocated and max_memory_allocated."""
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        memory_allocated=lambda i: 1000 * (i + 1),
        max_memory_allocated=lambda i: 5000 * (i + 1)))
    monkeypatch.setattr(tperf, "_cuda_devices", lambda: (fake, [0, 1]))
    s = tperf.sample_device_memory()
    assert s["devices"] == {"cuda:0": 1000, "cuda:1": 2000}
    assert s["peaks"] == {"cuda:0": 5000, "cuda:1": 10000}
    assert s["sources"] == {"cuda:0": "cuda_allocator",
                            "cuda:1": "cuda_allocator"}
    assert s["total"] == 3000
