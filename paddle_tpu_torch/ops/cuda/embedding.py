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

On CUDA tensors it sorts the rows stably and launches
``csrc/embedding_sgd.cu`` once, which sums each run of equal rows and
updates the table IN PLACE, returning ``w``; nothing waits on the host.
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


def _vec(w, vals):
    """Columns per lane: float2 loads from D 64, when D and both base
    pointers allow them."""
    d = w.shape[1]
    if d >= 64 and d % 2 == 0 and w.data_ptr() % 8 == 0 \
            and vals.data_ptr() % 8 == 0:
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
    if rows.shape[0] == 0:
        return w
    srows, order = torch.sort(rows, stable=True)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.embedding_sgd(
            w.data_ptr(), w.shape[0], w.shape[1], srows.data_ptr(),
            order.data_ptr(), vals.data_ptr(), rows.shape[0], lr.data_ptr(),
            _vec(w, vals), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"embedding_sgd launch failed: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")
    launches["embedding_sgd"] += 1
    return w


def _lib():
    lib = _build.load("embedding_sgd")
    if lib.embedding_sgd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.embedding_sgd.argtypes = [p, ll, i, p, p, p, ll, p, i, p]
        lib.embedding_sgd.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
