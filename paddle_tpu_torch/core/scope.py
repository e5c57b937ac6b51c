"""Scope: hierarchical name -> runtime value maps (counterpart of
paddle_tpu/core/scope.py). Runtime values are torch tensors on the
executor's device, or a ``torch.Generator`` for the startup initializers."""

from __future__ import annotations


class Scope:
    def __init__(self, parent: "Scope | None" = None):
        self._vars: dict[str, object] = {}
        self.parent = parent

    def set(self, name, value):
        self._vars[name] = value

    def find_var(self, name):
        """Lookup with parent recursion; None when absent."""
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def local_names(self):
        return list(self._vars)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope():
    global _global_scope
    _global_scope = Scope()
    return _global_scope
