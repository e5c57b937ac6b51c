"""DataFeeder: minibatch rows to a feed dict (counterpart of
paddle_tpu/fluid/data_feeder.py). A dense field becomes one array of the
batch, reshaped to the variable's declared shape; a ragged field
(``lod_level`` > 0) becomes a padded LoDArray (``pack_sequences``), its
longest length rounded up to ``pad_multiple``."""

from __future__ import annotations

import numpy as np

from ..core.lod import pack_sequences


def pack_column(column, dtype, lod_level, shape=None, pad_multiple=8):
    """One feed column: a dense array, or a LoDArray where ``lod_level`` >
    0 (a 1-D sequence becomes [len, 1])."""
    dtype = np.dtype(dtype)
    if lod_level > 0:
        seqs = [np.asarray(c, dtype=dtype) for c in column]
        if seqs and seqs[0].ndim == 1:
            seqs = [s[:, None] for s in seqs]
        return pack_sequences(seqs, dtype=dtype, pad_multiple=pad_multiple)
    arr = np.asarray(column, dtype=dtype)
    want = [s for s in (shape or ()) if s != -1]
    if want and list(arr.shape[1:]) != want:
        arr = arr.reshape([arr.shape[0]] + want)
    return arr


class DataFeeder:
    """``feed(minibatch)``: the rows (tuples aligned with ``feed_list``) as
    {variable name: column}. ``place`` and ``program`` are kept for the
    reference's signature; the executor moves feeds to its device."""

    def __init__(self, feed_list, place=None, program=None, pad_multiple=8):
        self.feed_vars = feed_list
        self.place = place
        self.pad_multiple = pad_multiple

    def feed(self, minibatch):
        feed = {}
        for i, var in enumerate(self.feed_vars):
            column = [row[i] for row in minibatch]
            feed[var.name] = pack_column(column, var.dtype, var.lod_level,
                                         var.shape,
                                         pad_multiple=self.pad_multiple)
        return feed


__all__ = ["DataFeeder", "pack_column"]
