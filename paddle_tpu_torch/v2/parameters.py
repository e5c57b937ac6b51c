"""v2 Parameters API (counterpart of paddle_tpu/v2/parameters.py;
reference python/paddle/v2/parameters.py:
``parameters = paddle.parameters.create(cost)``; names/shapes/get/set and
the to_tar/from_tar checkpoint form).

Here parameter storage is the fluid Scope (the reference wraps the C++
GradientMachine's parameter buffers); ``create`` returns a view bound to
the cost's program + a scope, initialized by the startup program on first
use by the trainer. to_tar writes one ``.npy`` member a parameter, as the
JAX package does, so either package's tar loads in the other; from_tar
loads onto the CPU, and an executor's reader (Inference, SGD) moves the
values to its device.
"""

from __future__ import annotations

import numpy as np
import torch


class Parameters:
    def __init__(self, program=None, scope=None):
        self._program = program
        self._scope = scope

    def _bind(self, scope):
        self._scope = scope

    def names(self):
        if self._program is None:
            # standalone (Parameters.from_tar in a fresh process): the scope
            # IS the parameter set
            return sorted(self._scope._vars)
        return [p.name for p in self._program.all_parameters()]

    def keys(self):
        return self.names()

    def shape(self, name):
        return tuple(self._program.global_block().var(name).shape)

    def get(self, name):
        if self._scope is None:
            raise RuntimeError("parameters not initialized yet (bind via "
                               "the trainer or pass a scope)")
        v = self._scope.find_var(name)
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def set(self, name, value):
        """Store ``value`` on the device of the value it replaces (the CPU
        for a new name)."""
        old = self._scope.find_var(name)
        device = old.device if isinstance(old, torch.Tensor) else "cpu"
        self._scope.set(name, torch.tensor(np.asarray(value), device=device))

    def __iter__(self):
        return iter(self.names())

    def to_tar(self, f):
        """Write every parameter as an .npy tar member (the reference's
        parameters.to_tar wire shape: one member per parameter)."""
        import tarfile
        import io
        with tarfile.open(fileobj=f, mode="w") as tf:
            for name in self.names():
                buf = io.BytesIO()
                np.save(buf, self.get(name), allow_pickle=False)
                data = buf.getvalue()
                info = tarfile.TarInfo(name=name + ".npy")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))

    def from_tar(self, f=None):
        """Works both as the instance method ``params.from_tar(f)`` and as
        the reference's class-level spelling ``Parameters.from_tar(f)``
        (reference v2/parameters.py declares it static) — the latter builds
        a standalone Parameters around a fresh scope."""
        import tarfile
        import io
        if f is None:
            f, self = self, Parameters()
        if self._scope is None:
            from ..core.scope import Scope
            self._scope = Scope()
        with tarfile.open(fileobj=f, mode="r") as tf:
            for m in tf.getmembers():
                if not m.name.endswith(".npy"):
                    continue
                arr = np.load(io.BytesIO(tf.extractfile(m).read()),
                              allow_pickle=False)
                self.set(m.name[:-4], arr)
        return self

    @classmethod
    def from_tar_file(cls, f):
        """Reference classmethod spelling ``Parameters.from_tar(f)`` used by
        every v2 example to load a trained model in a fresh process — builds
        a standalone scope holding the values."""
        return cls().from_tar(f)


def create(cost):
    """Parameters view over the program that computes ``cost`` (reference
    parameters.create walks the topology the same way)."""
    from .config_helpers import LayerOutput

    var = cost.var if isinstance(cost, LayerOutput) else cost
    return Parameters(var.block.program)


__all__ = ["Parameters", "create"]
