"""``paddle.v2.data_feeder`` — minibatch rows -> feed dict by data types.

Reference: python/paddle/v2/data_feeder.py (DataFeeder over
DataProviderConverter: ``feeder(minibatch)`` converts reader rows into
Arguments keyed by the topology's data layers, with an optional ``feeding``
map when row columns and data layers aren't one-to-one). Here the produced
structure is the executor feed dict (dense arrays / packed LoDArrays), via
the fluid DataFeeder's packing.
"""

from __future__ import annotations

from ..fluid.data_feeder import pack_column

__all__ = ["DataFeeder", "default_feeding_map"]


def default_feeding_map(data_types):
    return {name: i for i, (name, _tp) in enumerate(data_types)}


class DataFeeder:
    def __init__(self, data_types, feeding=None, pad_multiple=8):
        """data_types: [(name, InputType)] (e.g. from Topology.data_type());
        feeding: list of names or {name: column-index} when reader rows
        carry extra/reordered columns."""
        self.data_types = list(data_types)
        if feeding is None:
            feeding = default_feeding_map(self.data_types)
        elif not isinstance(feeding, dict):
            feeding = {name: i for i, name in enumerate(feeding)}
        self.feeding = feeding
        self.pad_multiple = pad_multiple

    def __call__(self, minibatch):
        return self.feed(minibatch)

    def feed(self, minibatch):
        out = {}
        for name, tp in self.data_types:
            col = self.feeding[name]
            column = [row[col] for row in minibatch]
            out[name] = pack_column(column, tp.dtype, tp.lod_level,
                                    tp.shape, pad_multiple=self.pad_multiple)
        return out
