"""SparseRows: the sparse-row gradient of an ``is_sparse`` embedding
(counterpart of paddle_tpu/core/sparse.py).

``lookup_table_grad`` with ``is_sparse`` emits W@GRAD as a ``SparseRows``:
one entry per looked-up id, ``values[i]`` the gradient of row ``rows[i]``
of the dense [nrows, ...] table. The number of entries is fixed by the
batch; ``rows`` may repeat and may hold sentinel entries ``>= nrows``
(padded LoD positions), which every consumer drops. ``merge_rows`` is the
reference's MergeAdd with the same static size: a stable sort and a
segment-sum, unique rows at the run heads, the sentinel ``nrows``
elsewhere. Optimizer sparse branches update only the touched rows
(``apply_rowwise``).

Nothing here waits on the device: no ``torch.unique``, no ``.item()``, no
boolean-mask indexing. Duplicates are summed by ``add_rows``, which adds a
row's entries one after another in the entries' order on either device,
with no atomics, so a merge gives the same bits on every run, and the
reference's sums. Scatters that must drop sentinels write into one padding
row past the table and slice it off.
"""

from __future__ import annotations

import torch


class SparseRows:
    """Sparse-row gradient (reference :28): ``values[i]`` is the partial
    gradient for row ``rows[i]`` (int64) of a dense [nrows, ...] tensor.
    Entries with ``rows[i] >= nrows`` are padding. ``merged`` marks rows as
    duplicate-free."""

    __slots__ = ("rows", "values", "nrows", "merged")

    def __init__(self, rows, values, nrows, merged=False):
        self.rows = rows
        self.values = values
        self.nrows = int(nrows)
        self.merged = bool(merged)

    @property
    def shape(self):
        return (self.nrows,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype):
        return SparseRows(self.rows, self.values.to(dtype), self.nrows,
                          self.merged)

    def to_dense(self):
        """Zeros [nrows, ...] with the values added in entry order;
        sentinel entries dropped."""
        return scatter_rows(self.values.new_zeros(self.shape), self.rows,
                            self.values, accumulate=True)

    def __repr__(self):
        return (f"SparseRows(n={self.rows.shape[0]}, nrows={self.nrows}, "
                f"dim={tuple(self.values.shape[1:])}, merged={self.merged})")


def _padded_rows(rows, nrows):
    """Rows with every sentinel (and any negative id) sent to ``nrows``, the
    padding row of a table grown by one."""
    return torch.where((rows < 0) | (rows >= nrows),
                       torch.full_like(rows, nrows), rows)


def add_rows(dense, rows, values):
    """Add ``values[i]`` to row ``rows[i]`` of ``dense`` in place, the
    entries of one row one after another in the entries' order, the same
    on every run. On the CPU ``index_add_`` does so (``index_put_`` with
    ``accumulate=True`` adds duplicates from several threads there); on
    CUDA ``index_put_`` with ``accumulate=True`` does (a stable sort of the
    rows, then each run summed in order; ``index_add_`` uses atomics).
    Returns ``dense``."""
    if dense.device.type == "cpu":
        return dense.index_add_(0, rows, values)
    return dense.index_put_((rows,), values, accumulate=True)


def scatter_rows(dense, rows, values, accumulate):
    """``dense`` with ``values`` written at ``rows`` (added, in the entries'
    order, with ``accumulate``); sentinel entries land on a padding row
    that is sliced off. A new tensor."""
    n = dense.shape[0]
    padded = torch.cat([dense, dense.new_zeros((1,) + dense.shape[1:])])
    rows, values = _padded_rows(rows, n), values.to(dense.dtype)
    if accumulate:
        add_rows(padded, rows, values)
    else:
        padded.index_put_((rows,), values)
    return padded[:n]


def merge_rows(sr: SparseRows) -> SparseRows:
    """Combine duplicate rows by summation (reference :75): sort the
    entries by row (stable, so each run keeps the entries' order), sum each
    run from zero in that order, emit the unique rows at the run heads and
    the sentinel ``nrows`` everywhere else. The static size is kept."""
    if sr.merged:
        return sr
    n = sr.rows.shape[0]
    if n == 0:
        return SparseRows(sr.rows, sr.values, sr.nrows, merged=True)
    srows, order = torch.sort(sr.rows, stable=True)
    head = torch.ones(n, dtype=torch.bool, device=srows.device)
    head[1:] = srows[1:] != srows[:-1]
    seg = torch.cumsum(head, 0) - 1
    merged_vals = add_rows(sr.values.new_zeros(sr.values.shape), seg,
                           sr.values[order])
    # every entry of a run writes the same row value to its segment
    merged_rows = torch.full_like(srows, sr.nrows).scatter_(0, seg, srows)
    return SparseRows(merged_rows, merged_vals, sr.nrows, merged=True)


def sparse_rows_from_grad(ids, grad_2d, nrows):
    """The W@GRAD SparseRows from flat ids [n] and per-id grads [n, d]
    (reference :104)."""
    return SparseRows(ids.long(), grad_2d, nrows)


def apply_rowwise(sr: SparseRows, states, update_fn):
    """A per-row optimizer update on the rows ``sr`` touches (reference
    :109). ``states`` are dense [nrows, ...] tensors (the parameter and its
    accumulators); ``update_fn(g_rows, *state_rows)`` returns the new state
    rows in the same order. Duplicates are merged first; sentinel rows
    gather row ``nrows - 1`` (the reference clamps) and their results are
    dropped. Returns new dense states."""
    m = merge_rows(sr)
    gather = m.rows.clamp(0, sr.nrows - 1)
    new_rows = update_fn(m.values, *[s[gather] for s in states])
    return [scatter_rows(s, m.rows, nr, accumulate=False)
            for s, nr in zip(states, new_rows)]


def is_sparse(v):
    return isinstance(v, SparseRows)


__all__ = ["SparseRows", "add_rows", "scatter_rows", "merge_rows",
           "sparse_rows_from_grad", "apply_rowwise", "is_sparse"]
