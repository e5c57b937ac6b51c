"""Merge a trained v2 model's topology + parameters into one file.

Reference: python/paddle/utils/merge_model.py merge_v2_model(net,
param_file, output_file) — writes the ModelConfig proto (size-prefixed)
followed by each parameter's header+body into a single binary consumed by
the C API. Here the artifact is a tar with ``__topology__.json`` (the
Topology inference serialization, v2/topology.py) plus the Parameters tar
members, and ``load_merged_model`` round-trips it back to
(topology_json, Parameters-dict) so both generations of inference
(paddle.infer / fluid executor) can consume the result.
"""

from __future__ import annotations

import io
import json
import os
import tarfile

__all__ = ["merge_v2_model", "load_merged_model"]

_TOPO_MEMBER = "__topology__.json"


def merge_v2_model(net, param_file, output_file):
    """net: the v2 output layer (LayerOutput), an inference Topology
    (v2/topology.py), or a parsed-config topology (config_helpers.Topology,
    whose outputs become the net); param_file: a Parameters ``to_tar`` file
    path; output_file: merged artifact path."""
    from ..v2.topology import Topology

    if not os.path.exists(param_file):
        raise FileNotFoundError(param_file)
    if hasattr(net, "serialize_for_inference"):
        topo = net
    elif hasattr(net, "outputs"):   # parsed-config topology
        topo = Topology(net.outputs)
    else:
        topo = Topology(net)
    buf = io.BytesIO()
    topo.serialize_for_inference(buf)

    with tarfile.open(output_file, "w") as out:
        info = tarfile.TarInfo(_TOPO_MEMBER)
        info.size = buf.getbuffer().nbytes
        buf.seek(0)
        out.addfile(info, buf)
        with tarfile.open(param_file, "r") as params:
            for member in params.getmembers():
                out.addfile(member, params.extractfile(member))


def load_merged_model(path):
    """Returns (topology_dict, param_tar_bytes): the deserialized topology
    JSON and the parameter archive re-packed so
    ``Parameters.from_tar_file(io.BytesIO(param_tar_bytes))`` restores the
    weights."""
    param_buf = io.BytesIO()
    with tarfile.open(path, "r") as tf, \
            tarfile.open(fileobj=param_buf, mode="w") as params:
        topo = json.loads(tf.extractfile(_TOPO_MEMBER).read().decode())
        for member in tf.getmembers():
            if member.name != _TOPO_MEMBER:
                params.addfile(member, tf.extractfile(member))
    param_buf.seek(0)
    return topo, param_buf.getvalue()
