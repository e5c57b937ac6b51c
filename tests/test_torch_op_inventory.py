"""Every op type the reference registers is either registered in the port
or queued here under the ROADMAP.md item that ports it. The queue only
shrinks: an op type the port registers must leave it, and the port
registers no op type the reference lacks.

Both registries are read in a fresh interpreter that imports the two
packages and nothing else: other test modules register op types of their
own into a worker's registries."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
ROADMAP = REPO / "ROADMAP.md"

_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
import paddle_tpu.fluid, paddle_tpu_torch.fluid
from paddle_tpu.core.registry import registered_ops as ref
from paddle_tpu_torch.core.registry import registered_ops as port
print(json.dumps({"reference": ref(), "port": port()}))
"""


@pytest.fixture(scope="module")
def registries():
    r = subprocess.run([sys.executable, "-c", _PROBE, str(REPO)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    return set(out["reference"]), set(out["port"])


# reference op type -> the ROADMAP.md item (queue A) that ports it; empty
# since the port registers every op type the reference does
PENDING = {}


def test_every_reference_op_is_ported_or_queued(registries):
    reference, port = registries
    missing = sorted(reference - port - set(PENDING))
    assert not missing, f"neither ported nor queued: {missing}"


def test_the_queue_holds_no_ported_op(registries):
    done = sorted(set(PENDING) & registries[1])
    assert not done, f"ported, take them out of PENDING: {done}"


def test_the_queue_holds_only_reference_ops(registries):
    unknown = sorted(set(PENDING) - registries[0])
    assert not unknown, unknown


def test_the_port_registers_no_op_the_reference_lacks(registries):
    reference, port = registries
    assert not sorted(port - reference)


def test_each_queue_item_is_in_the_roadmap():
    """Each item the queue names heads a numbered entry of ROADMAP.md's
    queue A ("N. **..."), or is named "A<N>" there."""
    text = ROADMAP.read_text()
    for item in sorted(set(PENDING.values())):
        n = item[1:]
        assert re.search(rf"^\s*{n}\. \*\*", text, re.M) or item in text, \
            item


def test_ported_and_queued_add_up_to_the_reference(registries):
    """Every reference op type counted once: ported or queued (239 and
    88 of 327 when the queue was written, 327 and 0 since)."""
    reference, port = registries
    assert len(port) + len(PENDING) == len(reference)
