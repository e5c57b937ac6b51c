"""Generation and serving telemetry on the obs.metrics registry, as the
reference keeps it: one store, which ``stats()`` reads.

* A process of each package that builds a ModelServer, an InferenceEngine
  and a GenerationEngine and runs one step with ``obs_op_metrics`` on
  registers the same metric families, but for the families of reference
  modules the port has not ported yet (each named below with the ROADMAP
  item that brings it).
* GenerationEngine's compile/hit counters and TTFT/TPOT histograms,
  ContinuousBatcher's request/overload counters and flight events, the KV
  cache's counters and gauges and the kernel tier's fallback counter are
  registry children, and ``stats()`` / the attributes read them.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.obs import metrics as obsm
from paddle_tpu_torch.obs import recorder
from paddle_tpu_torch.ops import cuda as tier
from paddle_tpu_torch.serving import ContinuousBatcher, GenerationEngine
from paddle_tpu_torch.serving.batcher import ServerOverloaded
from paddle_tpu_torch.testing.models import export_tiny_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = fluid.CPUPlace()
GEN = dict(max_seqs=2, block_size=4, num_blocks=32, max_len=32,
           prefill_buckets=(8,))

# reference families whose modules the port does not have yet
NOT_PORTED = {
    "paddle_tpu_compile_seconds": "obs/perf.py's compile log (A15)",
    "paddle_tpu_exec_cache_hits": "serving/execcache.py (A15)",
    "paddle_tpu_exec_cache_misses": "serving/execcache.py (A15)",
    "paddle_tpu_exec_cache_rejects": "serving/execcache.py (A15)",
    "paddle_tpu_exec_cache_save_seconds": "serving/execcache.py (A15)",
    "paddle_tpu_fleet_replicas": "serving/fleet.py (A15)",
    "paddle_tpu_fleet_request_seconds": "serving/fleet.py (A15)",
    "paddle_tpu_fleet_scale_events": "serving/autoscale.py (A15)",
    "paddle_tpu_router_ejections": "serving/router.py (A15)",
    "paddle_tpu_router_failovers": "serving/router.py (A15)",
    "paddle_tpu_router_quota_rejects": "serving/router.py (A15)",
    "paddle_tpu_router_requests": "serving/router.py (A15)",
    "paddle_tpu_router_spillovers": "serving/router.py (A15)",
    "paddle_tpu_kernel_autotune_rejects": "ops/autotune.py (A15)",
    "paddle_tpu_kernel_autotune_selections": "ops/autotune.py (A15)",
    "paddle_tpu_kernel_autotune_tunes": "ops/autotune.py (A15)",
    "paddle_tpu_kernel_variant_selected": "ops/autotune.py (A15)",
    "paddle_tpu_kvcache_spill_bytes": "serving/generate/kvstore.py (A15)",
    "paddle_tpu_kvcache_spill_rejects": "serving/generate/kvstore.py (A15)",
    "paddle_tpu_kvcache_spill_restores":
        "serving/generate/kvstore.py (A15)",
    "paddle_tpu_kvcache_spill_writes": "serving/generate/kvstore.py (A15)",
    "paddle_tpu_pserver_round_broken": "distributed/param_server.py (A14)",
    "paddle_tpu_pserver_round_shrunk": "distributed/param_server.py (A14)",
    "paddle_tpu_supervisor_restarts": "distributed/launch.py (A14)",
}

FAMILIES = r'''
import json, sys, tempfile
pkg = sys.argv[1]
d = tempfile.mkdtemp()
if pkg == "reference":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu.fluid as fluid
    from paddle_tpu.serving import InferenceEngine, ModelServer
    from paddle_tpu.serving.generate import GenerationEngine
    from paddle_tpu.testing.models import export_tiny_lm, build_mlp, mlp_feed
    from paddle_tpu.obs.metrics import REGISTRY
    place = {}
else:
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.serving import InferenceEngine, ModelServer
    from paddle_tpu_torch.serving.generate import GenerationEngine
    from paddle_tpu_torch.testing.models import (export_tiny_lm, build_mlp,
                                                 mlp_feed)
    from paddle_tpu_torch.obs.metrics import REGISTRY
    place = {"place": fluid.CPUPlace()}
exe = fluid.Executor(fluid.CPUPlace())
export_tiny_lm(d + "/lm", vocab=17, emb=8, heads=2, n_layers=2, max_pos=64,
               seed=3, **place)
main, startup, loss, logits = build_mlp(return_logits=True)
scope = fluid.Scope()
exe.run(startup, scope=scope)
fluid.io.save_inference_model(d + "/mlp", ["img"], [logits], exe, main,
                              scope=scope)
fluid.set_flags({"obs_op_metrics": True})
exe.run(main, feed=mlp_feed(2), fetch_list=[loss], scope=scope)
eng = InferenceEngine(d + "/mlp", buckets="1,2", **place)
eng.infer({"img": mlp_feed(1)["img"]})
server = ModelServer(d + "/mlp", engine=eng)
gen = GenerationEngine(d + "/lm", max_seqs=2, block_size=4, num_blocks=32,
                       max_len=32, prefill_buckets=(8,), **place)
gen.warmup()
print(json.dumps(REGISTRY.names()))
'''


def _families(pkg):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", FAMILIES, pkg],
                       capture_output=True, text=True, timeout=300,
                       env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_metric_families_equal_the_reference():
    port, ref = _families("port"), _families("reference")
    assert port - ref == set()
    assert ref - port == set(NOT_PORTED)
    for name in ("paddle_tpu_genengine_compiles", "paddle_tpu_genengine_hits",
                 "paddle_tpu_genengine_ttft_seconds",
                 "paddle_tpu_genengine_tpot_seconds",
                 "paddle_tpu_genbatcher_requests",
                 "paddle_tpu_genbatcher_rejected",
                 "paddle_tpu_executor_op_dispatches",
                 "paddle_tpu_executor_retraces",
                 "paddle_tpu_kvcache_prefix_hits",
                 "paddle_tpu_pallas_fallbacks"):
        assert name in port, name


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("telemetry") / "lm")
    export_tiny_lm(d, place=CPU, vocab=17, emb=8, heads=2, n_layers=2,
                   max_pos=64, seed=3)
    return d


def _child_values(family, instance):
    fam = obsm.REGISTRY.get(family)
    return {k: c for k, c in fam.children().items() if k[0] == instance}


def test_generation_engine_stats_read_the_registry(lm_dir):
    eng = GenerationEngine(lm_dir, place=CPU, **GEN)
    assert eng.warmup() == 2
    h, toks, fin = eng.start([1, 2, 3], 4)
    while not fin:
        for _h, _t, f in eng.step():
            fin = fin or f
    st = eng.stats()
    compiles = _child_values("paddle_tpu_genengine_compiles",
                             eng.obs_instance)
    hits = _child_values("paddle_tpu_genengine_hits", eng.obs_instance)
    for (inst, phase, bucket), c in compiles.items():
        n = int(c.value) + int(hits[(inst, phase, bucket)].value)
        assert st["phases"][phase][int(bucket)]["dispatches"] == n
        assert int(c.value) == 1                  # the first dispatch
    assert st["dispatches"] == sum(
        int(c.value) for c in list(compiles.values()) + list(hits.values()))
    assert st["hot_recompiles"] == 0
    assert not hasattr(eng, "_dispatches")


def test_batcher_counters_histograms_and_flight_events(lm_dir):
    eng = GenerationEngine(lm_dir, place=CPU, **GEN)
    eng.warmup()
    b = ContinuousBatcher(eng, capacity=0)
    try:
        with pytest.raises(ServerOverloaded):
            b.submit([1, 2], 3)
    finally:
        assert b.close()
    b = ContinuousBatcher(eng)
    try:
        streams = [b.submit([1 + i, 2], 4) for i in range(3)]
        assert [len(list(s)) for s in streams] == [4, 4, 4]
    finally:
        assert b.close()
    st = b.stats()
    assert st["requests"] == 3 and st["rejected"] == 0
    req = _child_values("paddle_tpu_genbatcher_requests", b.obs_instance)
    assert int(req[(b.obs_instance,)].value) == 3
    assert st["ttft"]["count"] == 3 and st["tpot"]["count"] == 3
    assert eng.ttft is obsm.REGISTRY.get(
        "paddle_tpu_genengine_ttft_seconds").labels(
            instance=eng.obs_instance)
    events = recorder.RECORDER.events(kinds=("overload_reject",
                                             "gen_finish"))
    rejects = [e for e in events if e["kind"] == "overload_reject"]
    finishes = [e for e in events if e["kind"] == "gen_finish"
                and e["component"] == b.obs_instance]
    assert rejects and rejects[-1]["detail"]["capacity"] == 0
    assert len(finishes) == 3
    assert all(e["detail"]["reason"] == "finished"
               and e["detail"]["tokens"] == 4 for e in finishes)


def test_kv_cache_counters_are_registry_children(lm_dir):
    eng = GenerationEngine(lm_dir, place=CPU, prefix_cache_blocks=8, **GEN)
    eng.warmup()
    prompt = list(range(1, 9))
    for _ in range(2):
        h, _, fin = eng.start(prompt, 2)
        while not fin:
            for _h, _t, f in eng.step():
                fin = fin or f
    cache = eng.cache
    assert cache.prefix_hits > 0
    hits = _child_values("paddle_tpu_kvcache_prefix_hits",
                         cache.obs_instance)
    assert int(hits[(cache.obs_instance,)].value) == cache.prefix_hits
    assert cache.stats()["prefix_hits"] == cache.prefix_hits
    cached = _child_values("paddle_tpu_kvcache_blocks_cached",
                           cache.obs_instance)
    assert cached[(cache.obs_instance,)].value == \
        cache.stats()["blocks_cached"] > 0


def test_fallback_counts_read_the_registry():
    tier.reset_fallback_counts()
    fluid.set_flags({"kernel_tier": "cuda"})
    try:
        import torch
        assert not tier.use_kernel("probe_family", False,
                                   torch.device("cpu"))
        assert tier.use_kernel("probe_family", True, torch.device("cpu"))
    finally:
        fluid.set_flags({"kernel_tier": "auto"})
    fam = obsm.REGISTRY.get("paddle_tpu_pallas_fallbacks")
    assert fam.labels(kernel="probe_family").value == 1
    assert tier.fallback_counts() == {"probe_family": 1}
    tier.reset_fallback_counts()
    assert tier.fallback_counts() == {}
    assert np.isfinite(fam.total())
