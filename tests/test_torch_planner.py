"""The port's placement planner (paddle_tpu_torch/parallel/planner.py) on
the CPU: the counterparts of tests/test_placement_planner.py, case by
case, and the planner held against the reference's.

* unit — the search space is exactly the legal full-device-count
  factorizations, over-budget candidates are pruned and never ranked,
  the cost model is monotone in communication; no process group is
  needed to plan (a mesh of n ranks without one only plans);
* rediscovery — the hand-built lanes' meshes, a non-trivial mesh above
  all-dp on the wide MLP with FLOPs measured by ``obs.perf.attribute``
  (FlopCounterMode, equal to the analytic count), and ``apply`` at 8
  gloo ranks bitwise the hand-built ``ShardingPlan`` step, a pp, sp or
  ep axis included (in the mesh, used by no spec);
* cross-package — the same Program built by both front ends and planned
  with ``measure=False`` and the same rates gives the same candidates,
  ranking and chosen mesh in both;
* persistence — round trip, every typed reject falling back to a fresh
  search, a plan the reference wrote rejected as ``fingerprint``, and
  ``ModelRegistry.publish(plan=True)`` certifying a plan that a replica
  resolves with zero searches; the CLI.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.parallel import planner as jpl
from paddle_tpu.testing import models as jmodels
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.flags import get_flag, set_flags
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.obs import REGISTRY, perf
from paddle_tpu_torch.parallel import ShardingPlan, make_mesh
from paddle_tpu_torch.parallel import planner as pl
from paddle_tpu_torch.parallel.launch import RankPool
from paddle_tpu_torch.serving import ModelRegistry
from paddle_tpu_torch.testing import models, multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = fluid.CPUPlace()
RATES = pl._machine_rates("cpu")


def _totals(name):
    return REGISTRY.totals().get(name, 0)


def _reject_count(reason):
    fam = REGISTRY.snapshot().get("paddle_tpu_plan_rejects", {})
    for v in fam.get("values", ()):
        if v["labels"].get("reason") == reason:
            return v["value"]
    return 0


def _features(sig, **kw):
    kw.setdefault("batch", 8)
    kw.setdefault("param_shapes", {"w": (64, 256)})
    kw.setdefault("layer_chain", 1)
    return pl.ProgramFeatures(signature=sig, **kw)


@pytest.fixture(scope="module")
def pool():
    with RankPool(8, "gloo", timeout=240) as p:
        yield p


# ---------------------------------------------------------------------------
# unit tier: search space + legality
# ---------------------------------------------------------------------------

def test_enumerate_full_device_count_factorizations():
    _, cands = pl.enumerate_meshes(_features("full-use"), 8)
    assert cands
    for c in cands:
        assert c.n_devices == 8, c.describe()
        assert c.axes == tuple(a for a in ("dp", "ep", "pp", "tp", "sp")
                               if c.sizes[a] > 1) or c.axes == ("dp",)
    # planning needs no process group: every candidate's mesh builds
    assert not torch.distributed.is_initialized()
    for c in cands:
        mesh, splan = c.build()
        assert mesh.devices.size == 8 and isinstance(splan, ShardingPlan)


def test_tp_legality_needs_a_shardable_param():
    _, cands = pl.enumerate_meshes(
        _features("tp-leg", param_shapes={"w": (64, 250)}), 8)
    assert {c.sizes["tp"] for c in cands} == {1, 2}
    _, cands = pl.enumerate_meshes(
        _features("tp-none", param_shapes={"w": (64, 251)}), 8)
    assert {c.sizes["tp"] for c in cands} == {1}
    f = _features("tp-emit", param_shapes={"w": (64, 256)})
    assert f.tp_shardable_bytes(8) > 0
    mesh = make_mesh(8, axes=("dp", "tp"))
    assert ShardingPlan(mesh)._base_spec("w", (64, 256)) != \
        ShardingPlan(mesh)._base_spec("w", (64, 251))


def test_pp_legality_needs_a_deep_enough_layer_chain():
    _, cands = pl.enumerate_meshes(_features("pp-1", layer_chain=1), 8)
    assert {c.sizes["pp"] for c in cands} == {1}
    _, cands = pl.enumerate_meshes(_features("pp-2", layer_chain=2), 8)
    assert {c.sizes["pp"] for c in cands} == {1, 2}
    _, cands = pl.enumerate_meshes(_features("pp-8", layer_chain=8), 8)
    assert 8 in {c.sizes["pp"] for c in cands}


def test_sp_legality_needs_attention_and_divisible_seq():
    _, cands = pl.enumerate_meshes(_features("sp-no-attn"), 8)
    assert {c.sizes["sp"] for c in cands} == {1}
    _, cands = pl.enumerate_meshes(
        _features("sp-attn", attention=True, seq_len=128), 8)
    assert 8 in {c.sizes["sp"] for c in cands}
    _, cands = pl.enumerate_meshes(
        _features("sp-12", attention=True, seq_len=12), 8)
    assert {c.sizes["sp"] for c in cands} == {1, 2, 4}


def test_ep_legality_needs_declared_experts():
    _, cands = pl.enumerate_meshes(_features("ep-none"), 8)
    assert {c.sizes["ep"] for c in cands} == {1}
    _, cands = pl.enumerate_meshes(_features("ep-4", moe_experts=4), 8)
    eps = {c.sizes["ep"] for c in cands}
    assert 4 in eps and 8 not in eps


def test_dp_legality_needs_divisible_batch():
    _, cands = pl.enumerate_meshes(
        _features("dp-b4", batch=4, layer_chain=8), 8)
    assert 8 not in {c.sizes["dp"] for c in cands}
    _, cands = pl.enumerate_meshes(_features("dp-anon", batch=None), 8)
    assert 8 in {c.sizes["dp"] for c in cands}


def test_no_legal_mesh_is_a_typed_error():
    with pytest.raises(pl.PlanError, match="no legal mesh"):
        pl.enumerate_meshes(
            _features("none", batch=3, param_shapes={"w": (64, 251)}), 8)


# ---------------------------------------------------------------------------
# unit tier: cost model + pruning
# ---------------------------------------------------------------------------

def test_memory_budget_prunes_never_ranks():
    f = _features("budget", layer_chain=8,
                  param_shapes={f"w{i}": (4001, 4001) for i in range(8)})
    rep = pl.plan(f, n_devices=8, memory_budget=300_000_000)
    assert rep.chosen is not None
    assert rep.chosen.sizes["pp"] == 8
    pruned = rep.pruned()
    assert pruned
    for c in pruned:
        assert c.pruned == "memory_budget"
        assert c.cost.memory_bytes > 300_000_000
        assert "budget" in c.note
        assert c not in rep.ranked()
    assert "pruned: memory_budget" in rep.render()


def test_all_candidates_pruned_apply_raises_typed():
    rep = pl.plan(_features("all-pruned"), n_devices=8, memory_budget=1)
    assert rep.chosen is None and not rep.ranked()
    with pytest.raises(pl.PlanError, match="memory_budget"):
        rep.apply(None, None, None, None)


def test_cost_monotone_doubling_comm_never_improves_rank():
    f = _features("mono", batch=8, layer_chain=4, attention=True,
                  seq_len=64, param_shapes={"w1": (512, 512),
                                            "w2": (512, 512)})
    _, cands = pl.enumerate_meshes(f, 8)
    totals = [pl.cost_candidate(f, c).total_s() for c in cands]
    for i, c in enumerate(cands):
        doubled = pl.cost_candidate(f, c, comm_scale=2.0).total_s()
        assert doubled >= totals[i]
        old_rank = sum(1 for t in totals if t < totals[i])
        new_rank = sum(1 for j, t in enumerate(totals)
                       if j != i and t < doubled)
        assert new_rank >= old_rank, c.describe()


def test_max_candidates_caps_and_records_drops():
    f = _features("cap", layer_chain=4, attention=True, seq_len=64,
                  param_shapes={"w": (64, 256)})
    full = pl.plan(f, n_devices=8, max_candidates=0)
    capped = pl.plan(f, n_devices=8, max_candidates=3)
    assert len(full.ranked()) > 3
    assert len(capped.ranked()) == 3
    assert capped.dropped == len(full.ranked()) - 3
    assert "dropped" in capped.render()
    assert [c.describe() for c in capped.ranked()] == \
        [c.describe() for c in full.ranked()[:3]]


def test_machine_rates_are_the_devices_and_carry_no_tpu_number():
    assert set(pl.PEAK_FLOPS_S) == set(pl.COLLECTIVE_BYTES_S) \
        == {"cuda", "cpu"}
    assert pl._machine_rates("cpu") == (pl.PEAK_FLOPS_S["cpu"],
                                        pl.COLLECTIVE_BYTES_S["cpu"])
    assert pl._machine_rates("cuda:0") == (pl.PEAK_FLOPS_S["cuda"],
                                           pl.COLLECTIVE_BYTES_S["cuda"])
    # the plan flags, with the reference's defaults
    from paddle_tpu.core.flags import get_flag as jget_flag
    for n in ("plan_memory_budget_bytes", "plan_max_candidates",
              "plan_cache_dir"):
        assert get_flag(n) == jget_flag(n), n


# ---------------------------------------------------------------------------
# rediscovery tier: the hand-tuned lane meshes
# ---------------------------------------------------------------------------

def _hand_mesh(axes, n=8):
    m = make_mesh(n, axes=axes)
    return m.axis_names, m.devices.shape


def test_rediscovers_all_dp_for_small_model_large_batch():
    main, _startup, loss = models.build_mlp()
    feed = models.mlp_feed(64)
    rep = pl.plan(main, feed_example=feed, n_devices=8, fetch_list=[loss],
                  measure=False)
    assert (rep.chosen.axes, rep.chosen.shape) == _hand_mesh(("dp",))


def test_rediscovers_dp_tp_mesh():
    rep = pl.plan(_features("re-dptp", param_shapes={"w": (512, 1002)}),
                  n_devices=8)
    assert (rep.chosen.axes, rep.chosen.shape) == _hand_mesh(("dp", "tp"))


def test_rediscovers_dp_pp_tp_mesh():
    f = _features("re-dpptp", layer_chain=2,
                  param_shapes={"w1": (1002, 1002), "w2": (1002, 1002)})
    rep = pl.plan(f, n_devices=8)
    assert (rep.chosen.axes, rep.chosen.shape) == \
        _hand_mesh(("dp", "pp", "tp"))


def test_rediscovers_pure_pipeline():
    f = _features("re-pp", batch=1, layer_chain=4,
                  param_shapes={f"w{i}": (250, 251) for i in range(4)})
    rep = pl.plan(f, n_devices=4)
    assert (rep.chosen.axes, rep.chosen.shape) == _hand_mesh(("pp",), 4)


def test_rediscovers_expert_parallel():
    f = _features("re-ep", moe_experts=8, param_shapes={"w": (64, 250)})
    rep = pl.plan(f, n_devices=8)
    assert (rep.chosen.axes, rep.chosen.shape) == _hand_mesh(("ep",))


def test_rediscovers_ring_attention_sp():
    f = _features("re-sp", batch=1, attention=True, seq_len=128,
                  param_shapes={"w": (250, 251)})
    rep = pl.plan(f, n_devices=8)
    assert (rep.chosen.axes, rep.chosen.shape) == _hand_mesh(("sp",))


def test_rediscovers_dp_sp_mesh():
    f = _features("re-dpsp", batch=4, attention=True, seq_len=128,
                  param_shapes={"w": (250, 251)})
    rep = pl.plan(f, n_devices=8)
    assert (rep.chosen.axes, rep.chosen.shape) == _hand_mesh(("dp", "sp"))


def _mul_flops(main, batch):
    """The analytic FLOPs of a training program's matmuls: 2·b·k·n for
    each ``mul`` and for each product its ``mul_grad`` forms (dY always,
    dX where the op writes X@GRAD)."""
    block = main.global_block()
    total = 0
    for op in block.ops:
        if op.type not in ("mul", "mul_grad"):
            continue
        k, n = (int(d) for d in block.var(op.input("Y")[0]).shape)
        prods = 1 if op.type == "mul" else (
            bool(op.output("Y@GRAD")) + bool(op.output("X@GRAD")))
        total += prods * 2 * batch * k * n
    return total


def test_non_trivial_mesh_beats_naive_all_dp():
    main, startup, loss = models.build_mlp(dim=512, classes=256,
                                           hidden=2048)
    scope = Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    before = {n: scope.find_var(n).clone()
              for n in scope.local_names()
              if isinstance(scope.find_var(n), torch.Tensor)}
    feed = models.mlp_feed(8, 512, 256)
    rep = pl.plan(main, feed_example=feed, n_devices=8, fetch_list=[loss],
                  executor=exe, scope=scope)
    alldp = rep.candidate(dp=8)
    assert alldp is not None
    assert rep.chosen.sizes != alldp.sizes, "planner never beat all-dp"
    assert rep.chosen.cost.total_s() < alldp.cost.total_s()
    feats = pl.extract_features(main, feed_example=feed, fetch_list=[loss],
                                executor=exe, scope=scope)
    # the measured compute term: FlopCounterMode's count of the step,
    # which is the matmuls' analytic count
    assert feats.flops == _mul_flops(main, 8) > 0
    # measuring ran the op loop on copies: the scope did not move
    for n, t in before.items():
        assert torch.equal(scope.find_var(n), t), n


def test_planned_mesh_wall_clock_beats_all_dp():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 8:
        pytest.skip("the wall-clock verdict needs 8 cards joined by NVLink "
                    "(a mesh of 8 ranks); fewer cards judge the cost model "
                    "only")
    main, startup, loss = models.build_mlp(dim=512, classes=256,
                                           hidden=2048)
    feed = models.mlp_feed(8, 512, 256)
    rep = pl.plan(main, feed_example=feed, n_devices=8, fetch_list=[loss],
                  measure=False)
    assert rep.chosen.describe() != rep.candidate(dp=8).describe()


def test_apply_bitwise_equal_to_hand_built_plan(pool):
    """``apply_candidate`` at 8 gloo ranks: bitwise the step of the same
    mesh and plan built by hand, for all-dp, dp×tp and ZeRO-1, on the
    reference's MLP."""
    feeds = [models.mlp_feed(8, seed=s) for s in range(3)]
    for sizes, kw in (({"dp": 8}, None), ({"dp": 4, "tp": 2}, None),
                      ({"dp": 8}, {"shard_opt_state": True})):
        res = pool.run(multichip.planned_run, models.build_mlp, {}, feeds,
                       8, sizes, kw)
        for r in res:
            assert r["planned"] == r["hand"] == res[0]["planned"], sizes
    # report.apply() routes the chosen candidate the same way (one rank:
    # a candidate of more devices refuses without their ranks)
    main, startup, loss = models.build_mlp()
    scope = Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rep = pl.plan(main, feed_example=feeds[0], n_devices=1,
                  fetch_list=[loss], measure=False)
    fn, state, fd, splan = rep.apply(exe, main, feeds[0], [loss],
                                     scope=scope)
    _state, f = fn(state, fd)
    assert np.isfinite(float(f[0])) and isinstance(splan, ShardingPlan)
    big = pl.plan(main, feed_example=feeds[0], n_devices=8,
                  fetch_list=[loss], measure=False)
    with pytest.raises(pl.PlanError, match="needs 8 ranks"):
        big.apply(exe, main, feeds[0], [loss], scope=scope)


@pytest.mark.parametrize("sizes,kw", [
    ({"dp": 2, "pp": 2, "tp": 2}, None),
    ({"dp": 4, "sp": 2}, None),
    ({"dp": 2, "sp": 4}, {"shard_opt_state": True}),
], ids=["dp2xpp2xtp2", "dp4xsp2", "dp2xsp4-zero1"])
def test_unused_mesh_axes_apply_bitwise_at_8_ranks(pool, sizes, kw):
    """A candidate with a pp or sp axis (in the mesh, used by no spec, as
    in the reference) emits through ``shard_program_step`` at 8 gloo ranks:
    bitwise the hand-built step, and the single-device step's losses
    within the reference's tolerance."""
    feeds = [multichip.lm_train_feed(8, 8, seed=s) for s in range(3)]
    single = multichip.single_run(multichip.build_lm_train, {}, feeds)
    res = pool.run(multichip.planned_run, multichip.build_lm_train, {},
                   feeds, 8, sizes, kw)
    for r in res:
        assert r["planned"] == r["hand"] == res[0]["planned"]
    np.testing.assert_allclose(res[0]["losses"], single["losses"],
                               rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# cross-package: the same candidates, ranking and choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw,batch,n", [
    ("build_mlp", {}, 64, 8),
    ("build_mlp", dict(dim=512, classes=256, hidden=2048), 8, 8),
    ("build_mlp", dict(depth=3, hidden=256), 16, 8),
    ("build_tiny_lm", {}, 8, 8),
    ("build_tiny_lm", dict(n_layers=4, emb=64), 4, 4),
])
def test_plan_matches_the_reference(name, kw, batch, n):
    """Both front ends build the program; both planners plan it with
    measure=False and the same rates: the same candidate set, ranking
    (with each candidate's modeled cost) and chosen mesh."""
    if name == "build_mlp":
        jmain = jmodels.build_mlp(**kw)[0]
        tmain = models.build_mlp(**kw)[0]
        feed = models.mlp_feed(batch, kw.get("dim", 16),
                               kw.get("classes", 4))
    else:
        jmain = jmodels.build_tiny_lm(**kw)[0]
        tmain = models.build_tiny_lm(**kw)[0]
        feed = {"tokens": np.zeros((batch, 16, 1), np.int64),
                "positions": np.zeros((batch, 16, 1), np.int64)}
    orig = jpl._machine_rates
    jpl._machine_rates = lambda: RATES
    try:
        jrep = jpl.plan(jmain, feed_example=feed, n_devices=n,
                        measure=False, max_candidates=0)
    finally:
        jpl._machine_rates = orig
    trep = pl.plan(tmain, feed_example=feed, n_devices=n, measure=False,
                   max_candidates=0, rates=RATES)

    def rows(rep):
        return [(c.describe(), c.pruned, round(c.cost.total_s(), 15),
                 c.cost.memory_bytes) for c in rep.candidates]

    assert rows(trep) == rows(jrep)
    assert trep.chosen.describe() == jrep.chosen.describe()


# ---------------------------------------------------------------------------
# persistence tier: artifacts, rejects, registry
# ---------------------------------------------------------------------------

def test_store_round_trip_is_a_cache_hit(tmp_path):
    f = _features("persist")
    s0 = _totals("paddle_tpu_plan_searches")
    rep = pl.plan(f, n_devices=8, store=pl.PlanStore(str(tmp_path)))
    assert _totals("paddle_tpu_plan_searches") == s0 + 1
    h0 = _totals("paddle_tpu_plan_cache_hits")
    rep2 = pl.plan(f, n_devices=8, store=pl.PlanStore(str(tmp_path)))
    assert _totals("paddle_tpu_plan_cache_hits") == h0 + 1
    assert _totals("paddle_tpu_plan_searches") == s0 + 1
    assert rep2.from_cache
    assert rep2.chosen.describe() == rep.chosen.describe()
    assert [c.describe() for c in rep2.ranked()] == \
        [c.describe() for c in rep.ranked()]
    assert rep2.chosen.build()[0].axis_names == \
        rep.chosen.build()[0].axis_names


def test_plan_cache_dir_flag_resolves_a_store(tmp_path):
    old = get_flag("plan_cache_dir")
    set_flags({"plan_cache_dir": str(tmp_path)})
    try:
        f = _features("flag-store")
        pl.plan(f, n_devices=8)
        arts = [x for x in os.listdir(tmp_path)
                if x.endswith(pl.ARTIFACT_SUFFIX)]
        assert len(arts) == 1
        h0 = _totals("paddle_tpu_plan_cache_hits")
        pl.plan(f, n_devices=8)
        assert _totals("paddle_tpu_plan_cache_hits") == h0 + 1
    finally:
        set_flags({"plan_cache_dir": old})


def _envelope(doc):
    import hashlib
    blob = json.dumps(doc, sort_keys=True).encode()
    return (pl._MAGIC + hashlib.sha256(blob).hexdigest().encode()
            + b"\n" + blob)


def test_every_reject_reason_counts_and_falls_back(tmp_path):
    f = _features("rejects")
    store = pl.PlanStore(str(tmp_path))
    rep = pl.plan(f, n_devices=8, store=store)
    path = store.artifact_path(rep.fingerprint)
    good = open(path, "rb").read()
    foreign = rep.to_doc()
    foreign["fingerprint"] = dict(foreign["fingerprint"], n_devices=99)
    cases = {
        "format": good[:-3] + b"xyz",
        "deserialize": _envelope({"schema": "wrong"}),
        "fingerprint": _envelope(foreign),
    }
    for reason, raw in cases.items():
        with open(path, "wb") as fh:
            fh.write(raw)
        before = _reject_count(reason)
        searches = _totals("paddle_tpu_plan_searches")
        got = pl.plan(f, n_devices=8, store=pl.PlanStore(str(tmp_path)))
        assert _reject_count(reason) == before + 1, reason
        assert _totals("paddle_tpu_plan_searches") == searches + 1
        assert got.chosen is not None and not got.from_cache
    with open(path, "wb") as fh:
        fh.write(good)
    pinned = pl.PlanStore(str(tmp_path), readonly=True,
                          expected_digests={os.path.basename(path):
                                            "0" * 64})
    before = _reject_count("manifest")
    assert pinned.load(rep.fingerprint) is None
    assert _reject_count("manifest") == before + 1
    unlisted = pl.PlanStore(str(tmp_path), readonly=True,
                            expected_digests={})
    before = _reject_count("manifest")
    assert unlisted.load(rep.fingerprint) is None
    assert _reject_count("manifest") == before + 1
    os.unlink(path)
    counts = {r: _reject_count(r) for r in pl.REJECT_REASONS}
    assert pl.PlanStore(str(tmp_path)).load(rep.fingerprint) is None
    assert counts == {r: _reject_count(r) for r in pl.REJECT_REASONS}


def test_reference_plan_artifact_is_a_fingerprint_reject(tmp_path):
    """A plan the reference wrote (the same envelope and schema, its
    fingerprint naming jax) found where the port looks: a typed
    ``fingerprint`` reject and a fresh search, never a failure."""
    f = _features("cross-artifact")
    jf = jpl.ProgramFeatures(signature="cross-artifact", batch=8,
                             param_shapes={"w": (64, 256)}, layer_chain=1)
    jstore = jpl.PlanStore(str(tmp_path / "ref"))
    jrep = jpl.plan(jf, n_devices=8, store=jstore)
    raw = open(jstore.artifact_path(jrep.fingerprint), "rb").read()
    assert "jax" in jrep.fingerprint
    store = pl.PlanStore(str(tmp_path / "port"))
    fp = pl.plan_fingerprint(f.signature, 8)
    with open(store.artifact_path(fp), "wb") as fh:
        fh.write(raw)
    before = _reject_count("fingerprint")
    searches = _totals("paddle_tpu_plan_searches")
    got = pl.plan(f, n_devices=8, store=store)
    assert _reject_count("fingerprint") == before + 1
    assert _totals("paddle_tpu_plan_searches") == searches + 1
    assert not got.from_cache
    assert got.chosen.describe() == jrep.chosen.describe()


def test_report_doc_round_trip_strict():
    f = _features("doc-rt", attention=True, seq_len=64, layer_chain=2)
    rep = pl.plan(f, n_devices=8, memory_budget=10**12)
    rt = pl.PlacementReport.from_doc(json.loads(json.dumps(rep.to_doc())))
    assert rt.to_doc() == rep.to_doc()
    assert rt.chosen.describe() == rep.chosen.describe()
    for bad in ({}, {"schema": "pdtpu-plan-v1"},
                {"schema": "pdtpu-plan-v1", "fingerprint": {},
                 "n_devices": 8,
                 "candidates": [{"sizes": {"zz": 2}}]}):
        with pytest.raises(ValueError):
            pl.PlacementReport.from_doc(bad)


def _export_mlp(export_dir):
    scope = Scope()
    exe = fluid.Executor(CPU)
    main, startup, _loss, logits = models.build_mlp(return_logits=True)
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(export_dir), ["img"], [logits], exe,
                                  main_program=main, scope=scope)


def test_registry_publish_plan_certifies_and_replicas_load(tmp_path):
    export = tmp_path / "export"
    _export_mlp(export)
    reg = ModelRegistry(str(tmp_path / "registry"))
    v = reg.publish("mlp", str(export), plan=True, place=CPU)
    m = reg.manifest("mlp", v)
    assert m.get("plan_files"), "publish(plan=True) certified nothing"
    assert all(rel.startswith(f"{pl.PLAN_DIRNAME}/")
               and rel.endswith(pl.ARTIFACT_SUFFIX)
               for rel in m["plan_files"])
    reg.verify("mlp", v)
    path, _ = reg.resolve("mlp", v)
    store = pl.resolve_store(path)
    assert store is not None and store.readonly
    prog, feed_names, fetch_vars = fluid.io.load_inference_model(
        path, fluid.Executor(CPU), scope=Scope())
    feed = perf.template_feed(prog, feed_names,
                              batch=pl._device_count(torch.device("cpu")))
    h0 = _totals("paddle_tpu_plan_cache_hits")
    s0 = _totals("paddle_tpu_plan_searches")
    rep = pl.plan(prog, feed_example=feed, fetch_list=fetch_vars,
                  model_dir=path, measure=False)
    assert rep.from_cache and rep.chosen is not None
    assert _totals("paddle_tpu_plan_cache_hits") == h0 + 1
    assert _totals("paddle_tpu_plan_searches") == s0
    before = dict(m["plan_files"])
    reg.warm("mlp", v, plan=True, place=CPU)
    assert reg.manifest("mlp", v)["plan_files"] == before
    rel = sorted(m["plan_files"])[0]
    with open(os.path.join(path, rel), "ab") as fh:
        fh.write(b"x")
    with pytest.raises(ValueError, match="corrupt"):
        reg.verify("mlp", v)
    assert pl.resolve_store(path).load(rep.fingerprint) is None


def test_plan_pass_failure_never_breaks_publish(tmp_path, monkeypatch):
    from paddle_tpu_torch.obs.recorder import RECORDER

    export = tmp_path / "export"
    _export_mlp(export)
    monkeypatch.setattr(pl, "plan",
                        lambda *a, **kw: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    reg = ModelRegistry(str(tmp_path / "registry"))
    v = reg.publish("mlp", str(export), plan=True, place=CPU)
    assert reg.manifest("mlp", v).get("plan_files") == {}
    reg.verify("mlp", v)
    events = RECORDER.events(kinds={"plan_publish_failed"})
    assert any("boom" in str(e["detail"].get("error")) for e in events)


def test_tools_plan_parallel_cli_renders_and_certifies(tmp_path):
    export = tmp_path / "export"
    _export_mlp(export)
    reg = ModelRegistry(str(tmp_path / "registry"))
    v = reg.publish("mlp", str(export))
    path, _ = reg.resolve("mlp", v)
    cli = [sys.executable, "-m", "paddle_tpu_torch.tools.plan_parallel"]
    r = subprocess.run(cli + ["--bundle", path, "--certify", "--place",
                              "cpu", "--devices", "8"],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "placement plan over 8 devices" in r.stdout
    assert "->" in r.stdout
    files = reg.manifest("mlp", v)["plan_files"]
    assert files and all(os.path.exists(os.path.join(path, f))
                         for f in files)
    reg.verify("mlp", v)
    r2 = subprocess.run(cli + ["--bundle", path, "--json", "--place", "cpu",
                               "--devices", "8"],
                        capture_output=True, text=True, timeout=300,
                        cwd=REPO)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    doc = json.loads(r2.stdout)
    assert pl.PlacementReport.from_doc(doc).chosen is not None
    # a bare program, planned without its persistables
    r3 = subprocess.run(cli + ["--program", str(export), "--devices", "4"],
                        capture_output=True, text=True, timeout=300,
                        cwd=REPO)
    assert r3.returncode == 0, r3.stdout + r3.stderr
    assert "placement plan over 4 devices" in r3.stdout
    r4 = subprocess.run(cli + ["--bundle", str(tmp_path / "nope")],
                        capture_output=True, text=True, timeout=300,
                        cwd=REPO)
    assert r4.returncode == 2


# ---------------------------------------------------------------------------
# the features the planner reads
# ---------------------------------------------------------------------------

def test_attribute_per_op_structured_rows():
    main, startup, loss = models.build_mlp()
    scope = Scope()
    exe = fluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feed = models.mlp_feed(8)
    plain = perf.attribute(main, feed=feed, fetch_list=[loss],
                           executor=exe, scope=scope)
    assert "per_op" not in plain
    res = perf.attribute(main, feed=feed, fetch_list=[loss],
                         executor=exe, scope=scope, per_op=True)
    assert set(res) == set(plain) | {"per_op"}
    rows = res["per_op"]
    assert len(rows) == res["instructions"] == len(main.global_block().ops)
    for r in rows:
        assert set(r) == {"op", "kind", "flops", "bytes", "shape"}
        assert r["bytes"] >= 0
    flops_rows = [r for r in rows if r["flops"]]
    assert flops_rows and {r["kind"] for r in flops_rows} <= {"mul",
                                                              "mul_grad"}
    assert sum(r["flops"] for r in flops_rows) == res["cost"]["flops"] \
        == _mul_flops(main, 8)
    assert any(r["shape"] for r in rows)


def test_extract_features_reads_the_program():
    main, _startup, loss = models.build_mlp(depth=2)
    f = pl.extract_features(main, feed_example=models.mlp_feed(16),
                            measure=False)
    assert f.batch == 16
    assert f.layer_chain == 3
    assert not f.attention
    assert any(len(s) == 2 for s in f.param_shapes.values())
    assert f.signature == pl.program_signature(main)
    lm, _st, _logits = models.build_tiny_lm()
    lf = pl.extract_features(lm, measure=False)
    assert lf.attention
    # a failed measurement falls back to the static estimate
    bad = pl.extract_features(main, feed_example=models.mlp_feed(16),
                              fetch_list=["no_such_var"],
                              executor=fluid.Executor(CPU), scope=Scope())
    assert bad.flops is None and bad.flops_estimate() > 0
