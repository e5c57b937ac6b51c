"""Multi-host start-up on the port: the counterpart of
tests/test_multihost.py, which skips in the reference because jaxlib's CPU
backend has no cross-process collectives. The port's gloo ranks have
them, so here the psum and the sharded step are asserted.

``distributed.launch.launch`` starts 2 copies of a script as the ranks
(fresh interpreters that import nothing of the JAX package); each runs
``multihost_check``: ``init_multihost`` from the env:// variables, or
again from an explicit coordinator address, the global mesh, a
cross-rank psum of the ranks' row indices (28 over 8 rows), and 3 steps
of the MLP's sharded step, whose losses must fall and equal the
single-device steps'. The launcher's own contract: exit codes 0, 1 for a
rank that raised, and a killed rank (not a stalled test) when the join
times out. ``global_mesh`` lays 4 ranks out as 2 hosts of 2.
"""

import os
import time

import numpy as np

from paddle_tpu_torch.distributed.launch import free_port, launch
from paddle_tpu_torch.parallel.launch import RankPool
from paddle_tpu_torch.testing import multichip

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from paddle_tpu_torch.testing import multichip
r = multichip.multihost_check()
assert r["psum"] == 28.0 and r["info"]["process_count"] == 2, r
"""


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_two_process_psum_and_sharded_step(tmp_path):
    check = _script(tmp_path, "check.py", _CHECK_SCRIPT)
    assert launch(check, [_REPO], nproc=2, timeout=120) == [0, 0]
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


def test_launch_reports_failed_and_hung_ranks(tmp_path):
    """A rank that raises exits 1; ranks still running at the timeout are
    killed (a negative code), and the call returns in about the timeout."""
    fail = _script(tmp_path, "fail.py", "1 / 0\n")
    assert launch(fail, nproc=2, timeout=60) == [1, 1]
    hang = _script(tmp_path, "hang.py", "import time\ntime.sleep(600)\n")
    t0 = time.monotonic()
    codes = launch(hang, nproc=2, timeout=5)
    assert all(c is not None and c < 0 for c in codes), codes
    assert time.monotonic() - t0 < 5 + 30


def test_global_mesh_puts_hosts_on_the_first_axis():
    """4 ranks as 2 hosts of 2 (LOCAL_WORLD_SIZE 2): the first axis spans
    the hosts, the second the ranks within one."""
    with RankPool(4, "gloo", timeout=120,
                  env={"LOCAL_WORLD_SIZE": "2"}) as pool:
        got = pool.run(multichip.host_layout, ("dp", "tp"))
    assert [c for c, _ in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(shape == {"dp": 2, "tp": 2} for _, shape in got)
