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

_BREADTH = (
    # paddle_tpu/ops/breadth_ops.py
    "average_accumulates", "conv3d_transpose", "conv3d_transpose_grad",
    "conv_shift", "conv_shift_grad", "detection_map",
    "expand", "expand_grad", "gaussian_random_batch_size_like", "l1_norm",
    "l1_norm_grad", "label_smooth", "label_smooth_grad",
    "max_pool3d_with_index", "minus", "modified_huber_loss",
    "modified_huber_loss_grad", "uniform_random_batch_size_like",
    # paddle_tpu/ops/misc_ops.py
    "bilinear_tensor_product", "bilinear_tensor_product_grad", "conv3d",
    "conv3d_grad", "cumsum", "is_empty",
    "margin_rank_loss", "margin_rank_loss_grad", "max_pool2d_with_index",
    "norm", "norm_grad", "pool3d", "pool3d_grad", "prelu", "prelu_grad",
    "spp", "spp_grad", "unpool", "unpool_grad",
    # paddle_tpu/ops/detection_ops.py
    "bipartite_match", "box_coder", "iou_similarity", "mine_hard_examples",
    "multiclass_nms", "prior_box", "roi_pool", "target_assign",
    # paddle_tpu/ops/io_ops.py: persistence, concurrency, memory passes
    "load", "load_combine", "save", "save_combine", "channel_close",
    "channel_create", "channel_recv", "channel_send", "go", "delete_var",
    "fill", "lod_array_length",
    # the rest of conv_ops.py, norm_ops.py and optimizer_ops.py
    "conv2d_transpose", "conv2d_transpose_grad", "depthwise_conv2d",
    "depthwise_conv2d_grad", "proximal_adagrad", "proximal_gd",
)

# reference op type -> the ROADMAP.md item (queue A) that ports it
PENDING = {
    **{t: "A12" for t in _BREADTH},
}


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


@pytest.mark.parametrize("item", sorted(set(PENDING.values())))
def test_each_queue_item_is_in_the_roadmap(item):
    """Each item the queue names heads a numbered entry of ROADMAP.md's
    queue A ("N. **..."), or is named "A<N>" there."""
    text = ROADMAP.read_text()
    n = item[1:]
    assert re.search(rf"^\s*{n}\. \*\*", text, re.M) or item in text, item


def test_ported_and_queued_add_up_to_the_reference(registries):
    """Every reference op type counted once: ported or queued (239 and
    88 of 327 when the queue was written)."""
    reference, port = registries
    assert len(port) + len(PENDING) == len(reference)
