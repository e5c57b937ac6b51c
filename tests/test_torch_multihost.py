"""Multi-host start-up on the port: the counterpart of
tests/test_multihost.py, which skips in the reference because jaxlib's CPU
backend has no cross-process collectives. The port's gloo ranks have
them, so here the psum and the sharded step are asserted.

``launch`` spawns 2 ranks (fresh interpreters that import nothing of the
JAX package); each runs ``multihost_check``: ``init_multihost`` from the
env:// variables, or again from an explicit coordinator address, the
global mesh, a cross-rank psum of the ranks' row indices (28 over 8
rows), and 3 steps of the MLP's sharded step, whose losses must fall and
equal the single-device steps'. The spawner's own contract: exit codes 0,
1 for a rank that raised, and a killed rank (not a stalled test) when
the join times out. ``global_mesh`` lays 4 ranks out as 2 hosts of 2.
"""

import operator
import time

import numpy as np

from paddle_tpu_torch.parallel.launch import RankPool, free_port, launch
from paddle_tpu_torch.testing import multichip


def test_two_process_psum_and_sharded_step():
    assert launch(multichip.multihost_check, nproc=2, timeout=120) == [0, 0]
    with RankPool(2, "gloo", timeout=120) as pool:
        for coordinator in (None, f"127.0.0.1:{free_port()}"):
            ranks = pool.run(multichip.multihost_check, coordinator)
            for r in ranks:
                assert r["psum"] == 28.0
                assert r["info"]["process_count"] == 2
                assert r["info"]["global_devices"] == 2
                np.testing.assert_allclose(r["losses"], r["single"],
                                           rtol=2e-5, atol=2e-6)
            assert [r["info"]["process_index"] for r in ranks] == [0, 1]


def test_launch_reports_failed_and_hung_ranks():
    """A rank that raises exits 1; ranks still running at the timeout are
    killed (a negative code), and the call returns in about the timeout."""
    assert launch(operator.truediv, nproc=2, args=(1, 0),
                  timeout=60) == [1, 1]
    t0 = time.monotonic()
    codes = launch(time.sleep, nproc=2, args=(600,), timeout=5)
    assert all(c is not None and c < 0 for c in codes), codes
    assert time.monotonic() - t0 < 5 + 120   # the start-up's own bound


def test_global_mesh_puts_hosts_on_the_first_axis():
    """4 ranks as 2 hosts of 2 (LOCAL_WORLD_SIZE 2): the first axis spans
    the hosts, the second the ranks within one."""
    with RankPool(4, "gloo", timeout=120,
                  env={"LOCAL_WORLD_SIZE": "2"}) as pool:
        got = pool.run(multichip.host_layout, ("dp", "tp"))
    assert [c for c, _ in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(shape == {"dp": 2, "tp": 2} for _, shape in got)
