"""The SGD, momentum and Adam updates over every dense float32 parameter in
one launch each (counterpart of paddle_tpu/ops/pallas/optimizer.py:
``sgd_arena_pallas`` :92, ``momentum_arena_pallas`` :111 and
``adam_arena_pallas`` :129, all wired through ``_arena_call`` :65).

``sgd_arena(ps, gs, lr)`` applies ``p' = p − lr·g`` to each parameter.
``momentum_arena(ps, gs, vs, lr, mu, nesterov)`` applies, to each
parameter p with gradient g and velocity v, ``v' = mu·v + g`` and
``p' = p − lr·v'`` (nesterov: ``p' = p − (g + mu·v')·lr``).
``adam_arena(ps, gs, m1s, m2s, lr, beta1_pow, beta2_pow, b1, b2, eps)``
applies ``m1' = b1·m1 + (1−b1)·g``, ``m2' = b2·m2 + (1−b2)·g·g`` and
``p' = p − lr_eff·m1' / (sqrt(m2') + eps)`` with the bias-corrected rate
``lr_eff = lr·sqrt(1 − beta2_pow) / (1 − beta1_pow)``.

On CUDA tensors each launches ``csrc/optimizer_arena.cu`` once for the
whole list (once per ``arena_max_rows`` parameters of a longer one) and
updates the parameters and their state IN PLACE, returning the same
tensors; the reference is functional and concatenates the state into one
flat arena first, which the kernels do not need. The wrapper packs the
parameters' pointers into a host table (``pack_table``) that the C entry
hands to the launch by value: no upload, no allocation. The params and
state tensors come back as the same objects every step (the update writes
them in place, and the executor hands the scope's tensors back), so their
checked columns are kept (``_tables``, weak references only) while the same
objects come back at the same addresses and sizes; the grads are checked
and their column filled on every call. On CPU tensors they run the
per-parameter expression (``sgd_arena_torch``, ``momentum_arena_torch``,
``adam_arena_torch``), which returns new tensors.
"""

from __future__ import annotations

import ctypes
import weakref
from array import array
from itertools import accumulate, chain
from operator import attrgetter, is_

import torch

from . import build as _build

# kernel launches since the last reset; only a launch adds
launches = {"sgd_arena": 0, "momentum_arena": 0, "adam_arena": 0}
# host tables packed since the last reset (a call whose params or state
# are not the kept ones packs anew); only a pack adds
packs = {"sgd_arena": 0, "momentum_arena": 0, "adam_arena": 0}

# elements per block of the kernels (csrc/optimizer_arena.cu CHUNK)
_CHUNK = 4096
_CHUNK_UP = (_CHUNK - 1).__add__
_T, _DTYPE, _SHAPE = torch.Tensor, attrgetter("dtype"), attrgetter("shape")
_F32 = frozenset({torch.float32})
_DEREF = weakref.ref.__call__


def reset_launches():
    for k in launches:
        launches[k] = 0
        packs[k] = 0


def _sgd_dense(p, g, lr):
    """One parameter's update (reference optimizer_ops.py::_sgd_dense),
    shared verbatim with the per-parameter ``sgd`` op."""
    return p - lr * g


def _momentum_dense(p, g, v, lr, mu, nesterov):
    """One parameter's update (reference optimizer_ops.py::_momentum_dense),
    shared verbatim with the per-parameter ``momentum`` op."""
    v_new = mu * v + g
    if nesterov:
        return p - (g + mu * v_new) * lr, v_new
    return p - lr * v_new, v_new


def _adam_dense(p, g, m1, m2, lr_eff, b1, b2, eps):
    """One parameter's update (reference optimizer_ops.py::_adam_dense),
    shared verbatim with the per-parameter ``adam`` op. ``b1``, ``b2`` and
    ``eps`` are Python floats, so ``1 - b1`` is formed in double and
    rounded once to float32, as in the reference."""
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g * g
    return p - lr_eff * m1n / (torch.sqrt(m2n) + eps), m1n, m2n


def adam_lr(lr, beta1_pow, beta2_pow):
    """The bias-corrected rate ``lr·sqrt(1 − β2^t)/(1 − β1^t)`` (reference
    optimizer_ops.py:148, :435), on the device."""
    return lr * torch.sqrt(1 - beta2_pow) / (1 - beta1_pow)


def sgd_arena_torch(ps, gs, lr):
    """Plain version: the per-parameter expression over each parameter.
    Returns the new params."""
    return [_sgd_dense(p, g, lr) for p, g in zip(ps, gs)]


def momentum_arena_torch(ps, gs, vs, lr, mu, nesterov):
    """Plain version: the per-parameter expression over each parameter.
    Returns (new params, new velocities)."""
    out = [_momentum_dense(p, g, v, lr, mu, nesterov)
           for p, g, v in zip(ps, gs, vs)]
    return [o[0] for o in out], [o[1] for o in out]


def adam_arena_torch(ps, gs, m1s, m2s, lr, beta1_pow, beta2_pow, b1, b2,
                     eps):
    """Plain version: the per-parameter expression over each parameter.
    Returns (new params, new first moments, new second moments)."""
    lr_eff = adam_lr(lr, beta1_pow, beta2_pow)
    out = [_adam_dense(p, g, m1, m2, lr_eff, b1, b2, eps)
           for p, g, m1, m2 in zip(ps, gs, m1s, m2s)]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


def _fits(ts, shapes, di):
    """Every tensor of ``ts`` a contiguous float32 tensor of its shape in
    ``shapes`` on device index ``di`` (-1: the CPU)."""
    return _F32.issuperset(map(_DTYPE, ts)) \
        and {di}.issuperset(map(_T.get_device, ts)) \
        and all(map(_T.is_contiguous, ts)) \
        and list(map(_SHAPE, ts)) == shapes


def _device_index(dev):
    return dev.index if dev.type == "cuda" else -1


def _gather(name, lists, dev):
    """Check every tensor of ``lists`` (the params, then the grads and each
    state list) in one pass over them all: each a contiguous float32
    tensor of its param's shape on ``dev``. Returns (pointer columns,
    numels), lists of ints."""
    ps = lists[0]
    flat = list(chain(*lists))
    if not _fits(flat, list(map(_SHAPE, ps)) * len(lists),
                 _device_index(dev)):
        raise ValueError(
            f"{name}: each param, grad and state tensor must be a "
            f"contiguous float32 tensor of its param's shape on {dev}")
    ptrs = list(map(_T.data_ptr, flat))
    n = len(ps)
    return ([ptrs[k * n:(k + 1) * n] for k in range(len(lists))],
            list(map(_T.numel, ps)))


class _Packed:
    """A list's checked launch tables (``pack_table``), kept with weak
    references to its params and state tensors, their pointers and numels
    and the params' shapes; each call copies the tables and fills the
    copies' grads column, so concurrent callers share nothing mutable."""

    __slots__ = ("refs", "ptrs", "numels", "shapes", "tables", "starts")

    def __init__(self, kept, columns, numels, max_rows):
        self.refs = [list(map(weakref.ref, ts)) for ts in kept]
        self.ptrs = [columns[0]] + columns[2:]
        self.numels = numels
        self.shapes = list(map(_SHAPE, kept[0]))
        self.tables = pack_table(columns, numels, max_rows)
        # each table's first row in the list
        self.starts = list(range(0, len(numels), max_rows))

    def holds(self, kept):
        """The same objects at the same addresses and sizes: each kept
        tensor alive and ``is`` the one in ``kept``, with the data pointer
        and numel it was packed with."""
        return all(len(ts) == len(refs)
                   and all(map(is_, ts, map(_DEREF, refs)))
                   and list(map(_T.data_ptr, ts)) == ptrs
                   and list(map(_T.numel, ts)) == self.numels
                   for ts, refs, ptrs in zip(kept, self.refs, self.ptrs))


# the last list each arena packed: {name: _Packed}
_PACKED = {}


def _tables(name, ps, gs, state, dev, max_rows):
    """The launch tables of (params ``ps``, grads ``gs``, state lists
    ``state``) on ``dev``: [(table, rows, chunks)] as ``pack_table`` gives
    them, for ``max_rows(width)`` rows of ``width`` int64 a launch. The
    params' and state columns are checked and packed once and kept while
    the same objects come back at the same addresses and sizes; the grads
    are checked against the kept shapes and their column filled on every
    call. Anything else (another list, a replaced or resized tensor, a
    grad that does not fit) takes the full check (``_gather``), which
    raises ValueError on what the kernel cannot take, and packs anew."""
    kept = [ps, *state]
    e = _PACKED.get(name)
    if e is not None and e.holds(kept) \
            and _fits(gs, e.shapes, _device_index(dev)):
        gp = array("q", list(map(_T.data_ptr, gs)))
        tables = []
        for (kept_table, n, c), r0 in zip(e.tables, e.starts):
            table = kept_table[:]
            table[n:2 * n] = gp[r0:r0 + n]
            tables.append((table, n, c))
        return tables
    columns, numels = _gather(name, [ps, gs, *state], dev)
    e = _PACKED[name] = _Packed(kept, columns, numels,
                                max_rows(len(columns) + 2))
    packs[name] += 1
    return e.tables


def pack_table(columns, numels, max_rows):
    """The host tables of the launches, one for each ``max_rows`` rows:
    [(table, rows, chunks)]. A table is a flat array('q') of columns, row
    count apart: each pointer column, then the numels, then the first
    chunks (the prefix sum of the parameters' CHUNK pieces, from 0 in each
    launch); the C entry lays them out as rows in the launch."""
    counts = list(map(_CHUNK.__rfloordiv__, map(_CHUNK_UP, numels)))
    parts = []
    for r0 in range(0, len(numels), max_rows):
        r1 = r0 + max_rows
        firsts = list(accumulate(counts[r0:r1], initial=0))
        chunks = firsts.pop()
        table = array("q", chain(*(c[r0:r1] for c in columns),
                                 numels[r0:r1], firsts))
        parts.append((table, len(firsts), chunks))
    return parts


def _run(name, entry, ps, state, scalars, *args):
    """Check and pack the list, then launch the C entry ``entry``
    (table, rows, chunks, scalar pointers..., *args, stream) once per
    ``pack_table`` table that has work; count the launches."""
    if not ps or any(len(s) != len(ps) for s in state):
        raise ValueError(f"{name}: needs equal, non-empty lists of params, "
                         "grads and state")
    dev = scalars[0].device
    for s in scalars:
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != dev:
            raise ValueError(f"{name}: the learning rate (and beta powers) "
                             f"must be one-element float32 tensors on {dev}")
    tables = _tables(name, ps, state[0], state[1:], dev, _max_rows)
    lib = _lib()
    args = [s.data_ptr() for s in scalars] + list(args)
    for table, n, c in tables:
        if c == 0:
            continue
        err = _build.call_on(dev, getattr(lib, entry),
                             table.buffer_info()[0], n, c, *args)
        if err != 0:
            raise RuntimeError(
                f"{name} launch failed: CUDA error {err} "
                f"({lib.kernel_error_string(err).decode()})")
        launches[name] += 1


def sgd_arena(ps, gs, lr):
    """The SGD update of every parameter in ``ps``; ``lr`` is the float32
    learning-rate tensor (read on the device, no host sync). Returns the
    params."""
    if ps and ps[0].device.type == "cpu":
        return sgd_arena_torch(ps, gs, lr)
    _run("sgd_arena", "sgd_arena", ps, [gs], [lr])
    return list(ps)


def momentum_arena(ps, gs, vs, lr, mu, nesterov):
    """The momentum update of every parameter in ``ps``; ``lr`` is the
    float32 learning-rate tensor (read on the device, no host sync), ``mu``
    a Python float. Returns (params, velocities)."""
    if ps and ps[0].device.type == "cpu":
        return momentum_arena_torch(ps, gs, vs, lr, mu, nesterov)
    _run("momentum_arena", "momentum_arena", ps, [gs, vs], [lr],
         ctypes.c_float(mu), int(bool(nesterov)))
    return list(ps), list(vs)


def adam_arena(ps, gs, m1s, m2s, lr, beta1_pow, beta2_pow, b1, b2, eps):
    """The Adam update of every parameter in ``ps``: ``lr`` and the beta
    powers are float32 [1] tensors read on the device (lr_eff is formed
    there, no host sync), ``b1``, ``b2``, ``eps`` Python floats. Returns
    (params, first moments, second moments)."""
    if ps and ps[0].device.type == "cpu":
        return adam_arena_torch(ps, gs, m1s, m2s, lr, beta1_pow, beta2_pow,
                                b1, b2, eps)
    f = ctypes.c_float
    # (1 - b1) and (1 - b2) formed in double and rounded once, as the
    # per-parameter expression forms them
    _run("adam_arena", "adam_arena", ps, [gs, m1s, m2s],
         [lr, beta1_pow, beta2_pow], f(b1), f(1 - b1), f(b2), f(1 - b2),
         f(eps))
    return list(ps), list(m1s), list(m2s)


_MAX_ROWS = {}


def _max_rows(width):
    """The most rows of ``width`` int64 one launch's table holds (the C
    entry's parameter-space limit)."""
    n = _MAX_ROWS.get(width)
    if n is None:
        n = _MAX_ROWS[width] = _lib().arena_max_rows(width)
    return n


_LIB = []


def _lib():
    if not _LIB:
        lib = _build.load("optimizer_arena")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sgd_arena.argtypes = [p, i, i, p, p]
        lib.sgd_arena.restype = i
        lib.momentum_arena.argtypes = [p, i, i, p, f, i, p]
        lib.momentum_arena.restype = i
        lib.adam_arena.argtypes = [p, i, i, p, p, p, f, f, f, f, f, p]
        lib.adam_arena.restype = i
        lib.arena_max_rows.argtypes = [i]
        lib.arena_max_rows.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]
