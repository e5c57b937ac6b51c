"""Executor: runs a Program block op by op on torch tensors (counterpart of
paddle_tpu/core/executor.py, eager path only).

The reference's jit path traces the whole block into one XLA computation;
PyTorch runs eagerly, so this executor is the reference's eager interpreter
(``ExecContext`` :134, ``_run_ops`` :227, the eager branch of
``Executor.run`` :568/:607-614) and nothing else.

State contract: persistable variables live in a Scope between runs as torch
tensors on the executor's device. Temporaries live in a per-run dict; one
may also be a LoDArray or a SparseRows (an ``is_sparse`` embedding's
gradient), and the scope holds either as it is. Every op output whose name
the scope holds, or that the program declares persistable, is written back
after the run: an optimizer op's ParamOut names its Param, so the updated
parameter replaces it in the scope.

The op loop runs under ``torch.no_grad()``: gradients are ops of the
program (``fluid.backward``), not autograd tape. A grad lowering that asks
autograd for a vector-Jacobian product enables it locally
(``ops/common.py::vjp``). With ``amp=True`` it also runs under
``amp_guard`` (reference :610), so the GEMM ops compute in bfloat16
(``core/amp.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import registry
from .amp import amp_guard
from .block_walk import free_reads, written_names
from .lod import LoDArray, flat_to_lodarray, pack_sequences
from .scope import global_scope
from .sparse import SparseRows
from .types import torch_dtype

# scope slot of the startup initializers' torch.Generator
_RNG_KEY = "__rng__"


class Place:
    pass


class CPUPlace(Place):
    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    """One CUDA card, by index."""

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def resolve_device(place=None) -> torch.device:
    """The torch.device a place names. ``None`` means ``CUDAPlace(0)``; with
    no GPU present that raises: only an explicit ``CPUPlace()`` runs on the
    CPU."""
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if place is None or isinstance(place, CUDAPlace):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass fluid.CPUPlace() to run "
                "on the CPU")
        return torch.device("cuda", getattr(place, "device_id", 0))
    raise TypeError(f"unsupported place {place!r}")


class ExecContext:
    """Per-op view of the environment handed to op lowerings."""

    __slots__ = ("op", "block", "env", "device")

    def __init__(self, op, block, env, device):
        self.op = op
        self.block = block
        self.env = env
        self.device = device

    def input(self, slot):
        names = self.op.input(slot)
        if not names:
            raise KeyError(f"op {self.op.type}: missing input slot {slot!r}")
        return self._read(names[0])

    def _read(self, name):
        if name not in self.env:
            raise KeyError(
                f"op {self.op.type}: variable {name!r} used before definition")
        return self.env[name]

    def has_input(self, slot):
        return bool(self.op.input(slot))

    def inputs(self, slot):
        """Every value of a variadic slot (sum, fused_momentum), in order."""
        return [self._read(n) for n in self.op.input(slot)]

    def set_output(self, slot, value):
        names = self.op.output(slot)
        if names:
            self.env[names[0]] = value

    def set_outputs(self, slot, values):
        for n, v in zip(self.op.output(slot), values):
            self.env[n] = v

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def generator(self) -> torch.Generator:
        """The run's generator for random ops (seeded once per scope from
        ``program.random_seed``)."""
        return self.env[_RNG_KEY]


def _run_ops(block, env, device):
    """Run every op of a block over ``env`` in order."""
    for op in block.ops:
        registry.get_op_info(op.type).forward(
            ExecContext(op, block, env, device))


class Executor:
    """User-facing executor. Runs on ``cuda:0`` unless ``place`` is
    ``CPUPlace()``; ``amp=True`` runs every program under AMP (bfloat16
    compute, float32 master weights; reference :553-561)."""

    def __init__(self, place=None, amp=False):
        self.device = resolve_device(place)
        self.amp = amp

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        from ..fluid.framework import default_main_program

        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        block = program.global_block()
        feed_vals = self._prepare_feed(block, dict(feed or {}))

        if scope.find_var(_RNG_KEY) is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(int(program.random_seed or 0))
            scope.set(_RNG_KEY, g)

        env = {n: scope.find_var(n) for n in free_reads(program, 0)
               if n not in feed_vals and scope.has_var(n)}
        env.update(feed_vals)
        env[_RNG_KEY] = scope.find_var(_RNG_KEY)
        with torch.no_grad(), amp_guard(self.amp):
            _run_ops(block, env, self.device)
        for n in written_names(program, 0):
            if n in env and (scope.has_var(n) or (
                    block.has_var(n) and block.var(n).persistable)):
                scope.set(n, env[n])
        return [self._fetch_value(env[n], return_numpy) for n in fetch_names]

    def _prepare_feed(self, block, feed):
        """Feeds on the executor's device (reference :863-914). A dense
        tensor already there passes through as it is, in its own dtype, as
        the reference passes a ``jax.Array`` (:871-875): a bfloat16 image
        batch staged on the card stays bfloat16. Any other dense feed
        (numpy, a tensor on another device) is cast to the declared var
        dtype and moved (:910-914), and so is a LoD feed's data. Dense: a
        numpy array or tensor. LoD: a ``LoDArray``, the reference's ``(flat,
        lod offsets)`` tuple, or a list of per-sequence arrays fed to a
        ``lod_level > 0`` var."""
        out = {}
        for name, value in feed.items():
            var = block.var(name) if block.has_var(name) else None
            if isinstance(value, tuple) and len(value) == 2 \
                    and not np.isscalar(value[0]):
                value = flat_to_lodarray(value[0], value[1])
            elif isinstance(value, list) and value and var is not None \
                    and var.lod_level > 0 \
                    and isinstance(value[0], (np.ndarray, list)):
                value = pack_sequences([np.asarray(s) for s in value])
            if isinstance(value, LoDArray):
                out[name] = LoDArray(self._dense(value.data, var),
                                     self._to_device(value.lens)
                                     .to(torch.int32))
            elif isinstance(value, torch.Tensor) \
                    and value.device == self.device:
                out[name] = value
            else:
                out[name] = self._dense(value, var)
        return out

    def _to_device(self, value):
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        return t.to(self.device)

    def _dense(self, value, var):
        t = self._to_device(value)
        if var is not None and var.dtype is not None:
            t = t.to(torch_dtype(var.dtype))
        return t

    @staticmethod
    def _fetch_value(v, return_numpy):
        """A tensor, or a LoDArray (reference :924 hands it to the caller,
        who unpacks it with ``lodarray_to_flat``); numpy on the host unless
        ``return_numpy`` is False. A SparseRows comes back as itself, its
        tensors where they lie (reference :923-926; ``to_dense`` densifies
        it)."""
        if not return_numpy or isinstance(v, SparseRows):
            return v
        if isinstance(v, LoDArray):
            return LoDArray(Executor._fetch_value(v.data, True),
                            v.lens.cpu().numpy())
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()  # numpy has no bfloat16 without ml_dtypes
        return v.cpu().numpy()


__all__ = ["Executor", "CPUPlace", "CUDAPlace", "resolve_device"]
