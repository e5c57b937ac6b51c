"""Tensor layer functions (counterpart of paddle_tpu/fluid/layers/
tensor.py): ``concat`` (reference :30), which the word2vec N-gram model
joins its four context embeddings with. The other tensor layers wait for a
later slice."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def concat(input, axis=0):
    """The inputs joined along ``axis``; the output keeps the first
    input's LoD level."""
    helper = LayerHelper("concat")
    shapes = [v.shape for v in input]
    out_shape = None
    if all(s is not None for s in shapes):
        out_shape = list(shapes[0])
        out_shape[axis] = sum(s[axis] for s in shapes)
        out_shape = tuple(out_shape)
    out = helper.create_tmp_variable(input[0].dtype, shape=out_shape,
                                     lod_level=input[0].lod_level)
    helper.append_op("concat", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


__all__ = ["concat"]
