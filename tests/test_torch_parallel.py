"""The port's sharded program step on gloo ranks of the CPU: the
counterparts of tests/test_parallel.py, case by case.

As in the reference, dp / dp×tp / ZeRO-1 / conv+BN / LoD dp must agree
with the plain single-device Executor on the same feeds and parameters
(the reference's tolerances). The port has no GSPMD: the step adds the
collectives itself (parallel/sharding.py), so each case also checks the
part that would go wrong without them, and holds the port's losses to the
reference's single-device losses from the same startup state. Four ranks
(the reference uses 8 virtual devices), started once for the file;
every call on them is bounded by the pool's timeout. The plan's specs,
its dict round trip and the accumulator tagging need no ranks, and
neither does ``get_places``.
"""

import functools
import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import testing as jmodels
from paddle_tpu.parallel import (ShardingPlan as JPlan,
                                 make_mesh as jmake_mesh)
from jax.sharding import PartitionSpec as JP
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.parallel import ShardingPlan, make_mesh
from paddle_tpu_torch.parallel.launch import RankPool
from paddle_tpu_torch.parallel.sharding import P
from paddle_tpu_torch.testing import models as tmodels
from paddle_tpu_torch.testing import multichip

from torch_cross import ref_state

RANKS = 4
# the reference's tolerances (tests/test_parallel.py)
RTOL, ATOL = 2e-5, 2e-6
# the port's single-device losses against the reference's, 3 steps from
# the same state
CROSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    with RankPool(RANKS, "gloo", timeout=120) as p:
        yield p


def _builders(name):
    """The reference's and the port's ``testing`` builder ``name``."""
    return getattr(jmodels, name), getattr(tmodels, name)


def _run(pool, builders, build_kw, feeds, axes, plan_kw=None, shape=None):
    """The reference's single-device losses from its startup state, the
    port's plain Executor from that state, and the port's sharded step on
    every rank (the ranks' results, which must agree)."""
    jbuild, build = builders
    jfluid.framework.reset_unique_name()
    jmain, jstart, jloss = jbuild(**build_kw)
    jexe, jscope, state = ref_state(jmain, jstart)
    ref = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                     scope=jscope)[0])) for f in feeds]
    single = multichip.single_run(build, build_kw, feeds, state=state)
    ranks = pool.run(multichip.sharded_run, build, build_kw, feeds, axes,
                     plan_kw, state, shape)
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
    return ref, single, ranks[0]


def _check(ref, single, got, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(single["losses"], ref, rtol=CROSS_RTOL)
    assert got["losses"][-1] < got["losses"][0]   # actually trains
    for n, w in single["params"].items():
        scale = float(np.max(np.abs(w)))
        np.testing.assert_allclose(got["params"][n], w, rtol=0,
                                   atol=multichip.PARAM_LIMIT * scale,
                                   err_msg=n)


def _mlp_feeds(n=3):
    return [jmodels.mlp_feed(16)] * n


def test_dp_matches_single_device(pool):
    ref, single, got = _run(pool, _builders("build_mlp"), {}, _mlp_feeds(),
                            ("dp",))
    assert got["mesh"] == {"dp": RANKS}
    _check(ref, single, got)


def test_dp_tp_matches_single_device(pool):
    """dp×tp 2×2: every fc weight column-sharded over tp (its mul's output
    all-gathered, mul_grad's dX summed over tp), biases replicated."""
    ref, single, got = _run(pool, _builders("build_mlp"), {}, _mlp_feeds(),
                            ("dp", "tp"))
    assert got["mesh"] == {"dp": 2, "tp": 2}
    assert got["specs"]["fc_0.w_0"] == [None, "tp"]
    assert got["specs"]["fc_0.w_0_velocity_0"] == [None, "tp"]
    assert got["specs"]["fc_0.w_1"] == []     # the bias
    _check(ref, single, got)


def test_sharded_optimizer_state_matches(pool):
    """ZeRO-1: Adam's moments sharded on dim 0 over dp, each rank updating
    its rows of the parameter; numerics unchanged."""
    ref, single, got = _run(pool, _builders("build_mlp"), dict(opt="adam"),
                            _mlp_feeds(), ("dp",),
                            {"shard_opt_state": True})
    sharded = {n for n, s in got["specs"].items() if s and s[0] == "dp"}
    assert {"fc_0.w_0_moment1_0", "fc_0.w_0_moment2_0",
            "fc_0.w_1_moment1_0"} <= sharded, sharded
    assert not any("beta" in n for n in sharded)
    _check(ref, single, got)


def test_dp_convnet_bn_matches_single_device(pool):
    """conv+BN under dp: the statistics are the global batch's (sums and
    counts all-reduced in batch_norm and its grad), so sharded equals the
    single device up to float association."""
    feeds = [jmodels.convnet_feed(16)] * 3
    ref, single, got = _run(pool, _builders("build_convnet_slice"), {},
                            feeds, ("dp",))
    _check(ref, single, got, rtol=5e-5, atol=5e-6)


def test_dp_lod_seq_matches_single_device(pool):
    """Ragged (LoD) feeds split by sequences over dp: the ranks hold
    different token counts, and the mean loss takes the global count."""
    feeds = [jmodels.seq_feed(16, seed=3)] * 3
    lens = [len(s) for s in feeds[0]["src"]]
    quarter = [sum(lens[i:i + 4]) for i in range(0, 16, 4)]
    assert len(set(quarter)) > 1, quarter   # ragged across the ranks
    ref, single, got = _run(pool, _builders("build_seq_slice"), {}, feeds,
                            ("dp",))
    _check(ref, single, got)


@pytest.mark.parametrize("loss", ["reduce_mean", "sum_rows",
                                  "mean_rows_keep"])
def test_dp_reduce_loss_matches_single_device(pool, loss):
    """A loss that the reduce ops take over the batch: reduce_sum and
    reduce_mean over the rows sum over dp, reduce_mean (and its grad) over
    the global count, so each rank fetches the whole batch's loss and the
    single-device gradient, not its own loss and dp times the gradient."""
    builders = (functools.partial(multichip.build_mlp_reduced,
                                  fluid=jfluid),
                multichip.build_mlp_reduced)
    ref, single, got = _run(pool, builders, dict(loss=loss), _mlp_feeds(),
                            ("dp",))
    _check(ref, single, got)


@pytest.mark.parametrize("loss", ["reduce_max", "auc"])
def test_batch_reductions_without_a_collective_form_raise(pool, loss):
    """An op that reduces over the rows and that the step has no
    collective form for raises when the step is built, on every rank."""
    errs = pool.run(multichip.sharded_error, multichip.build_mlp_reduced,
                    dict(loss=loss), _mlp_feeds(1)[0], ("dp",))
    assert all(e and "sharded over 'dp'" in e for e in errs), errs


def test_accuracy_over_dp_is_the_whole_batchs(pool):
    """accuracy over a batch sharded over dp: each rank's Correct and
    Total summed over the ranks, then their quotient, the plain
    Executor's numbers on the whole batch, on every rank; and both the
    reference's accuracy on the whole batch (its step computes over the
    global batch) from the same startup state."""
    feed = _mlp_feeds(1)[0]
    jfluid.framework.reset_unique_name()
    jmain, jstart, _ = multichip.build_mlp_reduced(loss="accuracy",
                                                   fluid=jfluid)
    jexe, jscope, state = ref_state(jmain, jstart)
    acc_op, = [op for op in jmain.global_block().ops
               if op.type == "accuracy"]
    fetch = [acc_op.output(s)[0] for s in ("Accuracy", "Correct", "Total")]
    ref = [float(np.asarray(v)) for v in
           jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)]
    runs = pool.run(multichip.accuracy_run, feed, ("dp",), state)
    for r in runs:
        assert r["sharded"] == r["single"], r
    np.testing.assert_allclose(runs[0]["single"], ref, rtol=CROSS_RTOL)
    assert runs[0]["single"][1:] == ref[1:]     # the counts exactly
    assert runs[0]["single"][2] == 16


def test_lod_dp_needs_the_global_count(pool):
    """The same LoD step with the per-rank mean averaged over the ranks
    (what a step without the global count would compute) is another loss:
    the case above is not passing by accident."""
    feed = jmodels.seq_feed(16, seed=3)
    single = multichip.single_run(tmodels.build_seq_slice, {}, [feed])
    per_rank = []
    for i in range(RANKS):
        part = {k: v[i * 4:(i + 1) * 4] for k, v in feed.items()}
        per_rank.append(multichip.single_run(tmodels.build_seq_slice, {},
                                             [part])["losses"][0])
    assert abs(np.mean(per_rank) - single["losses"][0]) > 1e-4


def test_conv_filter_never_spatially_sharded():
    mesh = make_mesh(8, axes=("dp", "tp"))
    plan = ShardingPlan(mesh)
    assert plan.spec_for_param("conv2d_0.w_0", (64, 3, 8, 8)) == P()
    assert plan.spec_for_param("fc_0.w_0", (128, 64)) == P(None, "tp")
    plan2 = ShardingPlan(mesh, shard_conv_filters=True)
    assert plan2.spec_for_param("conv2d_0.w_0", (64, 3, 8, 8)) == P("tp")
    # the reference's plan on its 8 devices gives the same specs
    jplan = JPlan(jmake_mesh(8, axes=("dp", "tp")))
    for name, shape in (("conv2d_0.w_0", (64, 3, 8, 8)),
                        ("fc_0.w_0", (128, 64)), ("fc_0.b_0", (64,))):
        assert tuple(plan.spec_for_param(name, shape)) == \
            tuple(jplan.spec_for_param(name, shape)), name


def test_opt_state_spec():
    mesh = make_mesh(8, axes=("dp",))
    plan = ShardingPlan(mesh, shard_opt_state=True)
    assert plan.spec_for_param("conv2d_0.w_0_velocity_0", (64, 3, 3, 3)) \
        == P("dp", None, None, None)
    assert plan.spec_for_param("conv2d_0.w_0", (64, 3, 3, 3)) == P()
    assert plan.spec_for_param("fc_0.w_0_beta1_pow_0", (1,)) == P()


def test_zero1_shards_arbitrary_accumulator_names():
    """The accumulator tag the optimizer sets, not the name, decides: a
    novel accumulator name is still sharded over dp; without the tag the
    suffix rule does not know it."""
    from paddle_tpu_torch.fluid.optimizer import SGD

    class WeirdSGD(SGD):
        def _append_optimize_op(self, block, pg, startup):
            p, g = pg
            self._add_accumulator("exotic_running_stat", p, startup)
            block.append_op(
                "sgd", inputs={"Param": [p.name], "Grad": [g.name],
                               "LearningRate": [self._lr_var.name]},
                outputs={"ParamOut": [p.name]})

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[16])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=8))
        WeirdSGD(learning_rate=0.1).minimize(loss, startup)
    acc = [v for v in main.global_block().vars.values()
           if getattr(v, "optimizer_accumulator_for", None)]
    assert acc and any("exotic_running_stat" in v.name for v in acc)
    plan = ShardingPlan(make_mesh(8, axes=("dp",)), shard_opt_state=True)
    v = acc[0]
    assert plan.spec_for_param(v.name, v.shape, var=v) == P("dp", None)
    assert plan.spec_for_param(v.name, v.shape) == P()


def test_sharding_plan_dict_round_trip():
    """to_dict()/from_dict(): the plan survives JSON and rebuilds; its
    document is the reference's, so either package loads the other's."""
    rules = [(r"^emb_", P(None, "tp")), (r"_stat$", P(("dp", "tp")))]
    plan = ShardingPlan(make_mesh(8, axes=("dp", "tp")), rules=rules,
                        shard_conv_filters=True, shard_opt_state=True)
    doc = json.loads(json.dumps(plan.to_dict()))
    assert doc["schema"] == "pdtpu-sharding-plan-v1"
    rt = ShardingPlan.from_dict(doc)
    assert rt.to_dict() == plan.to_dict()
    assert rt.mesh.axis_names == ("dp", "tp")
    assert rt.mesh.devices.shape == (4, 2)
    for name, shape in (("fc_0.w_0", (16, 32)), ("emb_table", (12, 8)),
                        ("x_stat", (4,)), ("fc_0.w_0_velocity", (16, 32))):
        assert rt.spec_for_param(name, shape) == \
            plan.spec_for_param(name, shape), name
    jplan = JPlan(jmake_mesh(8, axes=("dp", "tp")),
                  rules=[(r"^emb_", JP(None, "tp")),
                         (r"_stat$", JP(("dp", "tp")))],
                  shard_conv_filters=True, shard_opt_state=True)
    assert jplan.to_dict() == doc
    assert JPlan.from_dict(doc).to_dict() == doc
    for bad in ({}, {"schema": "pdtpu-sharding-plan-v1"},
                {"schema": "pdtpu-sharding-plan-v1",
                 "mesh": {"axes": ["dp"], "shape": [4, 2]}},
                {"schema": "pdtpu-sharding-plan-v1",
                 "mesh": {"axes": ["dp"], "shape": [8]},
                 "rules": [["ok", [["dp"], 3]]]}):
        with pytest.raises(ValueError):
            ShardingPlan.from_dict(bad)


def test_a_mesh_without_a_process_group_only_plans():
    """Eight ranks and no process group: specs and shards work, any
    collective raises rather than computing a wrong step."""
    mesh = make_mesh(8, axes=("dp",))
    assert mesh.shape == {"dp": 8}
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        mesh.group("dp")
    assert make_mesh(axes=("dp",)).shape == {"dp": 1}


def _places(device_type, count, place):
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        out = tfluid.layers.get_places(device_count=count,
                                       device_type=device_type)
    return tfluid.Executor(place).run(main, fetch_list=[out],
                                      return_numpy=False)[0]


def test_get_places_lists_the_devices():
    cpu = tfluid.CPUPlace()
    assert _places("CPU", 0, cpu) == [torch.device("cpu")]
    assert _places("AUTO", 0, cpu) == [torch.device("cpu")]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert _places("CUDA", 0, cpu) == [torch.device("cuda", i)
                                           for i in range(n)]
        assert _places("CUDA", 1, cpu) == [torch.device("cuda", 0)]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _places("CUDA", 0, cpu)


def test_get_places_reference_counterpart():
    """The reference test's program (tests/test_io_ops.py:79): a
    get_places op with device_type CPU appended by hand."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[2])
        y = tfluid.layers.scale(x, scale=3.0)
        b = main.global_block()
        b.create_var(name="places")
        b.append_op("get_places", {}, {"Out": ["places"]},
                    {"device_type": "CPU"})
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": np.ones((1, 2), "float32")},
        fetch_list=[y, "places"], return_numpy=False)
    np.testing.assert_allclose(got[0].numpy(), [[3.0, 3.0]])
    assert got[1] == [torch.device("cpu")]
