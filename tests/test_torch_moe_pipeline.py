"""Expert parallelism (the MoE FFN's all-to-all over "ep") and pipeline
parallelism (the microbatch ring over "pp") on gloo ranks of the CPU: the
counterparts of tests/test_moe_pipeline.py, case by case.

Four ranks (the reference uses 8 virtual devices), except the composed
dp×pp×tp step, which needs its 2×2×2 mesh of 8. Where a case can, the
port's numbers are also held against the reference's functions (jax) on
the same numpy inputs: the replicated MoE forward and the sequential
stage fold.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.parallel import (moe_ffn as jmoe_ffn,
                                 pipeline_stack_reference as jfold)
import torch

from paddle_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                       shard_pipeline_params)
from paddle_tpu_torch.parallel.launch import RankPool
from paddle_tpu_torch.testing import multichip

RANKS = 4
TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def pool():
    with RankPool(RANKS, "gloo", timeout=120) as p:
        yield p


def test_moe_ffn_sharded_matches_replicated(pool):
    """The expert-sharded MoE (8 experts over 4 ranks, 16 tokens a rank)
    equals the replicated computation, and both equal the reference's
    moe_ffn on the same parameters."""
    n, d, h, e = 64, 16, 32, 8
    ranks = pool.run(multichip.moe_lane, n, d, h, e, 0)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
    got = ranks[0]
    np.testing.assert_allclose(got["out"], got["ref_out"], **TOL)
    np.testing.assert_allclose(got["aux"], got["ref_aux"], rtol=1e-5)
    x, params = multichip.moe_inputs(n, d, h, e, 0)
    want, want_aux = jmoe_ffn(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["aux"], float(want_aux), rtol=1e-5)


def test_moe_trains_and_balances(pool):
    """A routed MoE regression head trains through the all-to-alls; the
    aux loss keeps more than one expert in play."""
    ranks = pool.run(multichip.moe_train, 128, 8, 16, 4, 2, 200)
    losses = ranks[0]["losses"]
    assert all(r["losses"] == losses for r in ranks[1:])
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])
    assert ranks[0]["experts_used"] > 1


@pytest.mark.parametrize("n_micro", [4, 9])
def test_pipeline_matches_sequential(pool, n_micro):
    """The M+S-1-tick pipeline over 4 stages computes exactly the
    sequential fold, forward and gradient; the fold is the reference's."""
    mb, d = 8, 16
    got = pool.run(multichip.pipeline_lane, n_micro, mb, d, 6)[0]
    assert got["err"] <= 2e-6 and got["grad_err"] <= 2e-5, got
    ws, xs = multichip.pipeline_inputs(RANKS, n_micro, mb, d, 6)
    want = jfold(lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws),
                 jnp.asarray(xs))
    np.testing.assert_allclose(got["out"], np.asarray(want), **TOL)
    g = jax.grad(lambda p: jnp.sum(jfold(
        lambda w, x: jnp.tanh(x @ w), p, jnp.asarray(xs)) ** 2))(
        jnp.asarray(ws))
    np.testing.assert_allclose(got["grad"], np.asarray(g), rtol=2e-4,
                               atol=2e-5)


def test_pipeline_trains_through_backward(pool):
    """Autograd through the pipeline (the exchange's backward runs the ring
    the other way) trains the stage stack."""
    losses = pool.run(multichip.pipeline_train, 4, 8, 8, 7, 80)[0]["losses"]
    assert losses[-1] < 0.4 * losses[0], (losses[0], losses[-1])


def test_pipeline_rejects_mismatched_stage_count():
    """A rank must hold one stage: a stack of 8 where shard_pipeline_params
    would cut one is refused."""
    mesh = make_mesh(axes=("pp",))
    ws = torch.zeros((8, 4, 4))
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_apply(lambda w, x: x, ws, torch.zeros((2, 2, 4)), mesh)
    assert shard_pipeline_params(ws, mesh).shape == (1, 4, 4)


def test_composed_dp_pp_tp_training_step():
    """dp×pp×tp on one 2×2×2 mesh of 8 ranks: microbatches over dp, stages
    over pp, the Megatron column/row split over tp inside each stage;
    forward, the gradients of every stage weight and one SGD step match
    the sequential fold (the reference's dryrun limits)."""
    with RankPool(8, "gloo", timeout=120) as pool8:
        ranks = pool8.run(multichip.composed_lane, 4)
    got = ranks[0]
    assert got["mesh"] == {"dp": 2, "pp": 2, "tp": 2}
    assert got["err"] < 5e-5 and got["grad_err"] < 5e-4 \
        and got["sgd_err"] < 5e-4, got
    assert all(r == got for r in ranks[1:])


def test_make_mesh_three_axis_default_shape():
    mesh = make_mesh(8, axes=("dp", "pp", "tp"))
    assert mesh.shape == {"dp": 2, "pp": 2, "tp": 2}
