"""The momentum update over every dense float32 parameter in one launch
(counterpart of paddle_tpu/ops/pallas/optimizer.py::momentum_arena_pallas).

``momentum_arena(ps, gs, vs, lr, mu, nesterov)`` applies, to each
parameter p with gradient g and velocity v, ``v' = mu·v + g`` and
``p' = p − lr·v'`` (nesterov: ``p' = p − (g + mu·v')·lr``). On CUDA tensors
it launches ``csrc/optimizer_arena.cu`` once for the whole list and updates
p and v IN PLACE, returning the same tensors; the reference is functional
and concatenates the state into one flat arena first, which the kernel does
not need. On CPU tensors it runs :func:`momentum_arena_torch`, the
per-parameter expression, which returns new tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

# kernel launches since the last reset; only a launch adds
launches = {"momentum_arena": 0}

# elements per block of the kernel (csrc/optimizer_arena.cu CHUNK)
_CHUNK = 4096


def reset_launches():
    launches["momentum_arena"] = 0


def _momentum_dense(p, g, v, lr, mu, nesterov):
    """One parameter's update (reference optimizer_ops.py::_momentum_dense),
    shared verbatim with the per-parameter ``momentum`` op."""
    v_new = mu * v + g
    if nesterov:
        return p - (g + mu * v_new) * lr, v_new
    return p - lr * v_new, v_new


def momentum_arena_torch(ps, gs, vs, lr, mu, nesterov):
    """Plain version: the per-parameter expression over each parameter.
    Returns (new params, new velocities)."""
    out = [_momentum_dense(p, g, v, lr, mu, nesterov)
           for p, g, v in zip(ps, gs, vs)]
    return [o[0] for o in out], [o[1] for o in out]


def momentum_arena(ps, gs, vs, lr, mu, nesterov):
    """The momentum update of every parameter in ``ps``; ``lr`` is the
    float32 learning-rate tensor (read on the device, no host sync), ``mu``
    a Python float. Returns (params, velocities)."""
    if not (len(ps) == len(gs) == len(vs)) or not ps:
        raise ValueError("momentum_arena: needs equal, non-empty lists of "
                         "params, grads and velocities")
    if ps[0].device.type == "cpu":
        return momentum_arena_torch(ps, gs, vs, lr, mu, nesterov)
    rows = []
    chunks = 0
    for p, g, v in zip(ps, gs, vs):
        for name, t in (("param", p), ("grad", g), ("velocity", v)):
            if t.dtype != torch.float32 or t.device != lr.device \
                    or not t.is_contiguous() or t.shape != p.shape:
                raise ValueError(
                    f"momentum_arena: each {name} must be a contiguous "
                    f"float32 tensor of its param's shape on {lr.device}")
        rows.append((p.data_ptr(), g.data_ptr(), v.data_ptr(), p.numel(),
                     chunks))
        chunks += -(-p.numel() // _CHUNK)
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError("momentum_arena: lr must be a float32 [1] tensor")
    # the table goes up through pinned memory, so the copy does not wait
    # for the work queued before it
    table = torch.tensor(rows, dtype=torch.int64).pin_memory() \
        .to(lr.device, non_blocking=True)
    lib = _lib()
    with torch.cuda.device(lr.device):
        err = lib.momentum_arena(
            table.data_ptr(), len(rows), chunks, lr.data_ptr(),
            ctypes.c_float(mu), int(bool(nesterov)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"momentum_arena launch failed: CUDA error {err} "
            f"({lib.kernel_error_string(err).decode()})")
    launches["momentum_arena"] += 1
    return list(ps), list(vs)


def _lib():
    lib = _build.load("optimizer_arena")
    if lib.momentum_arena.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.momentum_arena.argtypes = [p, i, i, p, ctypes.c_float, i, p]
        lib.momentum_arena.restype = i
        lib.kernel_error_string.argtypes = [i]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib
