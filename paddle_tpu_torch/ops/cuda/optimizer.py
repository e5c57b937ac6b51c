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
whole list and updates the parameters and their state IN PLACE, returning
the same tensors; the reference is functional and concatenates the state
into one flat arena first, which the kernels do not need. On CPU tensors
they run the per-parameter expression (``sgd_arena_torch``,
``momentum_arena_torch``, ``adam_arena_torch``), which returns new
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

# kernel launches since the last reset; only a launch adds
launches = {"sgd_arena": 0, "momentum_arena": 0, "adam_arena": 0}

# elements per block of the kernels (csrc/optimizer_arena.cu CHUNK)
_CHUNK = 4096


def reset_launches():
    for k in launches:
        launches[k] = 0


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


def _table(name, ps, state, scalars):
    """The device table of (p, g, state..., numel, first chunk) rows, one
    per parameter, and the total chunk count. Every tensor must be a
    contiguous float32 tensor of its parameter's shape on the scalars'
    device."""
    if not ps or any(len(s) != len(ps) for s in state):
        raise ValueError(f"{name}: needs equal, non-empty lists of params, "
                         "grads and state")
    dev = scalars[0].device
    for s in scalars:
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != dev:
            raise ValueError(f"{name}: the learning rate (and beta powers) "
                             f"must be one-element float32 tensors on {dev}")
    rows, chunks = [], 0
    for i, p in enumerate(ps):
        ts = [p] + [s[i] for s in state]
        for t in ts:
            if t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous() or t.shape != p.shape:
                raise ValueError(
                    f"{name}: each param, grad and state tensor must be a "
                    f"contiguous float32 tensor of its param's shape on "
                    f"{dev}")
        rows.append([t.data_ptr() for t in ts] + [p.numel(), chunks])
        chunks += -(-p.numel() // _CHUNK)
    # the table goes up through pinned memory, so the copy does not wait
    # for the work queued before it
    table = torch.tensor(rows, dtype=torch.int64).pin_memory() \
        .to(dev, non_blocking=True)
    return table, len(rows), chunks, dev


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")


def sgd_arena(ps, gs, lr):
    """The SGD update of every parameter in ``ps``; ``lr`` is the float32
    learning-rate tensor (read on the device, no host sync). Returns the
    params."""
    if ps and ps[0].device.type == "cpu":
        return sgd_arena_torch(ps, gs, lr)
    table, rows, chunks, dev = _table("sgd_arena", ps, [gs], [lr])
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.sgd_arena(table.data_ptr(), rows, chunks, lr.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "sgd_arena")
    launches["sgd_arena"] += 1
    return list(ps)


def momentum_arena(ps, gs, vs, lr, mu, nesterov):
    """The momentum update of every parameter in ``ps``; ``lr`` is the
    float32 learning-rate tensor (read on the device, no host sync), ``mu``
    a Python float. Returns (params, velocities)."""
    if ps and ps[0].device.type == "cpu":
        return momentum_arena_torch(ps, gs, vs, lr, mu, nesterov)
    table, rows, chunks, dev = _table("momentum_arena", ps, [gs, vs], [lr])
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.momentum_arena(
            table.data_ptr(), rows, chunks, lr.data_ptr(),
            ctypes.c_float(mu), int(bool(nesterov)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "momentum_arena")
    launches["momentum_arena"] += 1
    return list(ps), list(vs)


def adam_arena(ps, gs, m1s, m2s, lr, beta1_pow, beta2_pow, b1, b2, eps):
    """The Adam update of every parameter in ``ps``: ``lr`` and the beta
    powers are float32 [1] tensors read on the device (lr_eff is formed
    there, no host sync), ``b1``, ``b2``, ``eps`` Python floats. Returns
    (params, first moments, second moments)."""
    if ps and ps[0].device.type == "cpu":
        return adam_arena_torch(ps, gs, m1s, m2s, lr, beta1_pow, beta2_pow,
                                b1, b2, eps)
    table, rows, chunks, dev = _table("adam_arena", ps, [gs, m1s, m2s],
                                      [lr, beta1_pow, beta2_pow])
    lib = _lib()
    f = ctypes.c_float
    with torch.cuda.device(dev):
        # (1 - b1) and (1 - b2) formed in double and rounded once, as the
        # per-parameter expression forms them
        err = lib.adam_arena(
            table.data_ptr(), rows, chunks, lr.data_ptr(),
            beta1_pow.data_ptr(), beta2_pow.data_ptr(), f(b1), f(1 - b1),
            f(b2), f(1 - b2), f(eps),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "adam_arena")
    launches["adam_arena"] += 1
    return list(ps), list(m1s), list(m2s)


def _lib():
    lib = _build.load("optimizer_arena")
    if lib.sgd_arena.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sgd_arena.argtypes = [p, i, i, p, p]
        lib.sgd_arena.restype = i
        lib.momentum_arena.argtypes = [p, i, i, p, f, i, p]
        lib.momentum_arena.restype = i
        lib.adam_arena.argtypes = [p, i, i, p, p, p, f, f, f, f, f, p]
        lib.adam_arena.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
