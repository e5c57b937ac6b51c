"""Ring attention (sequence parallelism) on gloo ranks of the CPU against
full attention: the counterparts of tests/test_ring_attention.py, case by
case, on 4 ranks (the reference's mesh has 8 devices).

Each case also holds the port's outputs and gradients against the
reference's ``ring_attention`` / ``full_attention`` (jax, on the 8
virtual CPU devices of tests/conftest.py) on the same numpy inputs. Every
rank returns the whole result (its blocks all-gathered), and the ranks
must agree.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.ring_attention import (
    full_attention as jfull_attention, ring_attention as jring_attention)
from paddle_tpu_torch.parallel.launch import RankPool
from paddle_tpu_torch.testing import multichip

RANKS = 4
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def pool():
    with RankPool(RANKS, "gloo", timeout=120) as p:
        yield p


def _lane(pool, *args, **kw):
    ranks = pool.run(multichip.ring_lane, *args, **kw)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
    return ranks[0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [16, 64])
def test_ring_matches_full_attention(pool, causal, seq):
    b, h, d = 2, 4, 8
    got = _lane(pool, b, seq, h, d, 0, causal)
    assert got["err"] <= 2e-5, got["err"]
    q, k, v = (jnp.asarray(a) for a in multichip.ring_inputs(b, seq, h, d,
                                                             0))
    np.testing.assert_allclose(got["out"], np.asarray(
        jfull_attention(q, k, v, causal=causal)), **TOL)
    want = jring_attention(q, k, v, jmake_mesh(8, axes=("sp",)),
                           axis="sp", causal=causal)
    np.testing.assert_allclose(got["out"], np.asarray(want), **TOL)


def test_ring_attention_is_actually_sequence_sharded(pool):
    """Each rank holds and returns only its block of the sequence: the
    local output's shape is [b, seq / 4, h, d], never the whole."""
    shapes = pool.run(multichip.ring_block_shape, 1, 32, 2, 4)
    assert shapes == [(1, 32 // RANKS, 2, 4)] * RANKS


def _jgrads(q, k, v, fn):
    return jax.grad(lambda qq, kk, vv: jnp.sum(fn(qq, kk, vv) ** 2),
                    argnums=(0, 1, 2))(q, k, v)


def test_ring_attention_grads_flow(pool):
    """autograd through the ring (the exchange's backward sends the
    cotangent back): dq, dk and dv of sum(out²), causal, against full
    attention's and against the reference's."""
    b, seq, h, d = 1, 16, 2, 4
    got = _lane(pool, b, seq, h, d, 2, True, grads=True)
    assert got["grad_err"] <= 2e-4, got
    q, k, v = (jnp.asarray(a) for a in multichip.ring_inputs(b, seq, h, d,
                                                             2))
    want = _jgrads(q, k, v, lambda a, c, e: jfull_attention(a, c, e, True))
    for name, w in zip("qkv", want):
        np.testing.assert_allclose(got["d" + name], np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_ring_attention_composes_with_data_parallel(pool):
    """dp×sp 2×2 (batch_axis): batch rows over dp while the ring runs over
    sp; outputs and dk against full attention and the reference's."""
    mesh_shape = (2, 2)
    b, seq, h, d = 4, 8, 2, 4
    got = _lane(pool, b, seq, h, d, 5, True, axes=("dp", "sp"),
                shape=mesh_shape, batch_axis="dp", grads=True)
    assert got["err"] <= 2e-4 and got["grad_err"] <= 2e-4, got
    q, k, v = (jnp.asarray(a) for a in multichip.ring_inputs(b, seq, h, d,
                                                             5))
    np.testing.assert_allclose(got["out"], np.asarray(
        jfull_attention(q, k, v, causal=True)), **GRAD_TOL)
    jmesh = jmake_mesh(8, axes=("dp", "sp"))
    want = np.asarray(jring_attention(q, k, v, jmesh, axis="sp",
                                      causal=True, batch_axis="dp"))
    np.testing.assert_allclose(got["out"], want, **GRAD_TOL)
    dk = jax.grad(lambda kk: jnp.sum(jfull_attention(
        q, kk, v, causal=True) ** 2))(k)
    np.testing.assert_allclose(got["dk"], np.asarray(dk), **GRAD_TOL)
