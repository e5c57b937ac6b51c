"""v2 Topology: the serializable (network, data-types) bundle behind
paddle.infer.

Reference: python/paddle/v2/topology.py — wraps the output layers' model
proto, exposes ``data_type()`` (the typed data layers the network reads)
and ``serialize_for_inference(stream)`` (the {protobin, data_type} pickle
the reference Inference(fileobj=...) loads). Here the fluid Program IS the
topology format: the bundle is the pruned for-test Program's JSON plus the
reconstructed InputTypes, so a trained v2 model round-trips through a
stream into a fresh process.
"""

from __future__ import annotations

import json

from . import data_type as v2_data_type


def _to_vars(layers):
    from .config_helpers import LayerOutput

    if not isinstance(layers, (list, tuple)):
        layers = [layers]
    out = []
    for l in layers:
        out.append(l.var if isinstance(l, LayerOutput) else l)
    return out


def _input_type_from_var(var):
    """Reconstruct the declaration-time InputType from the fluid data var
    (data_type.py maps InputType -> (dtype, shape, lod_level) exactly)."""
    shape = [int(s) for s in (var.shape or [1]) if s not in (None, -1)]
    dim = shape[-1] if shape else 1
    return v2_data_type.InputType(dim=dim, seq_type=1 if var.lod_level else 0,
                                  dtype=str(var.dtype or "float32"),
                                  shape=shape or [1],
                                  lod_level=int(var.lod_level or 0))


class Topology:
    """Topology(output_layer or [output_layers]) over the current program."""

    def __init__(self, layers, extra_layers=None):
        from ..fluid.io import _prune_program
        from .config_helpers import _DATA_LAYERS

        vars_ = _to_vars(layers) + _to_vars(extra_layers or [])
        self.fetch_names = [v.name for v in _to_vars(layers)]
        program = vars_[0].block.program
        self.program = _prune_program(program, [], self.fetch_names)
        block = self.program.global_block()

        # the data layers this pruned network actually reads, in declaration
        # order (reference Topology.data_type walks the proto's data layers)
        produced = set()
        read = set()
        for op in block.ops:
            for n in op.input_arg_names():
                if n not in produced:
                    read.add(n)
            produced.update(op.output_arg_names())
        self.feed_names = list(dict.fromkeys(
            d.name for d in _DATA_LAYERS
            if not d.is_pending and d.name in read and block.has_var(d.name)))
        # fluid-built programs have no v2 data-layer records; fall back to
        # free is_data vars
        if not self.feed_names:
            self.feed_names = [n for n in read
                               if block.has_var(n) and block.var(n).is_data]

    def data_type(self):
        """[(name, InputType)] for every data layer the network reads."""
        block = self.program.global_block()
        return [(n, _input_type_from_var(block.var(n)))
                for n in self.feed_names]

    def proto(self):
        """The serialized network (reference returns the ModelConfig proto;
        here the Program JSON — the framework's model wire format)."""
        return self.program.to_json()

    def serialize_for_inference(self, stream):
        """Write the inference bundle (reference topology.py
        serialize_for_inference: {protobin, data_type} via pickle; here a
        JSON document — no pickle, loadable anywhere)."""
        meta = self.program.to_dict()
        meta["feed_var_names"] = list(self.feed_names)
        meta["fetch_var_names"] = list(self.fetch_names)
        meta["data_types"] = [
            {"name": n, "dim": t.dim, "seq_type": t.seq_type,
             "dtype": t.dtype, "shape": t.shape, "lod_level": t.lod_level}
            for n, t in self.data_type()]
        data = json.dumps(meta).encode("utf-8")
        stream.write(data)


def load_serialized(fileobj):
    """Inverse of serialize_for_inference -> (program, feed_names,
    fetch_names)."""
    from ..fluid.framework import Program

    meta = json.loads(fileobj.read().decode("utf-8"))
    program = Program.from_dict(meta)
    return program, meta["feed_var_names"], meta["fetch_var_names"]


__all__ = ["Topology", "load_serialized"]
