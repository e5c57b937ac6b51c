"""The sparse SGD step of an embedding table (counterpart of
paddle_tpu/ops/pallas/embedding.py: ``embedding_sgd_pallas`` :40, kernel
``_row_sgd_kernel`` :35, with the ``merge_rows`` the sgd op runs before
it).

``embedding_sgd(w, rows, vals, lr)`` takes one gradient entry per
looked-up id, unmerged: ``rows`` [R] int64 (duplicates allowed; a row
``>= V`` or ``< 0`` is a sentinel and touches nothing), ``vals`` [R, D] and
the float32 learning rate. For each unique row r it applies
``w[r] = w[r] − lr·Σ vals`` over r's entries, the sum taken from zero in
the entries' order: the reference's sparse SGD branch under its Pallas
tier (merge, then the row update). Every other row stays bitwise as it was.

On CUDA tensors it updates the table IN PLACE and returns ``w``; nothing
waits on the host. A call of at most ``FUSED_MAX`` entries is one launch of
``csrc/embedding_sgd.cu``'s ``embedding_sgd_fused``, which sorts the entries
itself; a larger one is one call of ``embedding_sgd_sorted``, which sorts
the rows stably with the toolkit's radix sort (4-byte keys where the table
has fewer than 2**32 - 1 rows) in a workspace the wrapper allocates, then
launches the update. Either sums each run of equal rows in entry order and
writes the row once (``sort_path`` picks the path).
On CPU tensors it runs the plain version, ``embedding_sgd_torch``, the
same function in PyTorch ops (``core/sparse.py::merge_rows``, then the
row update), which returns a new table. ``embedding_sgd_scatter`` is the
reference's ``embedding_sgd_jnp`` (:80): the unmerged scatter-add of
``−lr·vals`` that the plain op chain runs, equal to the merged update up to
float32 roundings.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.sparse import SparseRows, merge_rows, scatter_rows
from . import build as _build

# kernel launches since the last reset; only a launch adds
launches = {"embedding_sgd": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def supported(w, vals):
    """The kernel's shapes: the reference's predicate (optimizer_ops.py:91,
    a 2-D table and 2-D values) and a float32 table."""
    return w.ndim == 2 and vals.ndim == 2 and w.dtype == torch.float32


def embedding_sgd_torch(w, rows, vals, lr):
    """Plain version: merge the entries, then ``w[r] − lr·s_r`` for each
    unique row. Returns a new table."""
    m = merge_rows(SparseRows(rows, vals, w.shape[0]))
    return scatter_rows(w, m.rows, w[m.rows.clamp(0, w.shape[0] - 1)]
                        - lr * m.values, accumulate=False)


def embedding_sgd_scatter(w, rows, vals, lr):
    """The unmerged scatter-add of ``−lr·vals`` (reference
    ``embedding_sgd_jnp``, the sgd op's jnp branch): each entry added to its
    row in the entries' order, sentinels dropped. Returns a new table."""
    return scatter_rows(w, rows, -lr * vals.to(w.dtype), accumulate=True)


# the one-launch path's entry limit (csrc/embedding_sgd.cu FUSED_MAX)
FUSED_MAX = 1024


def sort_path(n, nrows):
    """Where ``n`` entries into an ``nrows``-row table are sorted: "fused"
    (in the one launch, n <= FUSED_MAX), "keys32" (the library radix sort
    of 4-byte keys, the rows clamped to [-1, nrows] plus 1, where nrows <
    2**32 - 1) or "keys64" (the same with 8-byte keys)."""
    if n <= FUSED_MAX and nrows < 2 ** 53:
        return "fused"
    return "keys32" if nrows < 2 ** 32 - 1 else "keys64"


def _vec(w, vals):
    """Columns a copy or a lane's load takes: 4 (16-byte pieces) where D
    and the values' base pointer allow them, else 2, else 1."""
    d, ptr = w.shape[1], vals.data_ptr()
    if d % 4 == 0 and ptr % 16 == 0:
        return 4
    if d % 2 == 0 and ptr % 8 == 0:
        return 2
    return 1


def embedding_sgd(w, rows, vals, lr):
    """The sparse SGD step of ``w`` (see the module docstring); ``lr`` a
    one-element float32 tensor on ``w``'s device (a Python float on the
    CPU). Returns the updated table: ``w`` itself on CUDA."""
    if w.device.type == "cpu":
        return embedding_sgd_torch(w, rows, vals, lr)
    dev = w.device
    if not supported(w, vals) or not w.is_contiguous() \
            or vals.dtype != torch.float32 or not vals.is_contiguous() \
            or vals.shape[1] != w.shape[1] or rows.dtype != torch.int64 \
            or rows.shape != (vals.shape[0],) or rows.device != dev \
            or vals.device != dev:
        raise ValueError(
            "embedding_sgd: needs a contiguous float32 [V, D] table, "
            "contiguous float32 [R, D] values and int64 [R] rows, all on "
            f"{dev}")
    if not (torch.is_tensor(lr) and lr.dtype == torch.float32
            and lr.numel() == 1 and lr.device == dev):
        raise ValueError("embedding_sgd: the learning rate must be a "
                         f"one-element float32 tensor on {dev}")
    n = rows.shape[0]
    if n:
        _launch(w, rows, vals, lr, sort_path(n, w.shape[0]))
    return w


def _launch(w, rows, vals, lr, path):
    """One kernel launch for the checked operands, sorted as ``path``
    says (``sort_path``)."""
    fused, sorted_, workspace, error_string = _entries()
    v, d = w.shape
    n = rows.shape[0]
    if path == "fused":
        err = _build.call_on(w.device, fused, w.data_ptr(), v, d,
                             rows.data_ptr(), vals.data_ptr(), n,
                             lr.data_ptr(), _vec(w, vals))
    else:
        key_bytes = 4 if path == "keys32" else 8
        nbytes = workspace(n, v, key_bytes)
        if nbytes <= 0:
            raise ValueError(f"embedding_sgd: {n} entries into {v} rows "
                             "are past the sorted path's limits")
        buf = torch.empty(nbytes, dtype=torch.uint8, device=w.device)
        err = _build.call_on(w.device, sorted_, w.data_ptr(), v, d,
                             rows.data_ptr(), key_bytes, vals.data_ptr(), n,
                             lr.data_ptr(), _vec(w, vals), buf.data_ptr(),
                             nbytes)
    if err != 0:
        raise RuntimeError(f"embedding_sgd launch failed: CUDA error {err} "
                           f"({error_string(err).decode()})")
    launches["embedding_sgd"] += 1


_ENTRIES = []


def _entries():
    """The C entries (fused, sorted, workspace size, error string), typed
    once."""
    if not _ENTRIES:
        lib = _build.load("embedding_sgd")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.embedding_sgd_fused.argtypes = [p, ll, i, p, p, ll, p, i, p]
        lib.embedding_sgd_fused.restype = i
        lib.embedding_sgd_sorted.argtypes = [p, ll, i, p, i, p, ll, p, i, p,
                                             ll, p]
        lib.embedding_sgd_sorted.restype = i
        lib.embedding_sgd_workspace.argtypes = [ll, ll, i]
        lib.embedding_sgd_workspace.restype = ll
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _ENTRIES.extend([lib.embedding_sgd_fused, lib.embedding_sgd_sorted,
                         lib.embedding_sgd_workspace,
                         lib.kernel_error_string])
    return _ENTRIES
