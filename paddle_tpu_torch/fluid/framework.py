"""Program IR: Program / Block / Operator / Variable / Parameter
(counterpart of paddle_tpu/fluid/framework.py, a near-verbatim port).

A Program is a serializable tree of blocks of ops over typed vars, built by
the layers API and transformed source-to-source (fusion, inference pruning).
``Program.to_dict``/``from_dict`` read and write exactly the JSON the
reference package writes, so a ``__model__`` file from either package loads
in the other.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json

import numpy as np

from ..core.registry import GRAD_SUFFIX
from ..core.types import VarType, convert_dtype


def grad_var_name(name: str) -> str:
    """Gradient variable naming convention (reference framework.py uses @GRAD)."""
    return name + GRAD_SUFFIX


_name_counters = collections.defaultdict(int)


def unique_name(prefix: str) -> str:
    """Generate a unique variable name (fluid.unique_name.generate)."""
    _name_counters[prefix] += 1
    return f"{prefix}_{_name_counters[prefix] - 1}"


def reset_unique_name():
    _name_counters.clear()


class Variable:
    """A typed symbolic variable inside a Block.

    Reference: python/paddle/fluid/framework.py:117 (class Variable) wrapping
    VarDesc (framework.proto:157). Shape uses -1 for the batch (feed) dimension
    only; ``lod_level`` > 0 marks a ragged sequence tensor whose device form is
    padded data + lengths (core/lod.py).
    """

    def __init__(self, block, name, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 type=VarType.LOD_TENSOR, is_data=False):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self._persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        # populated for Parameter only
        self.initializer = None

    @property
    def persistable(self):
        return self._persistable

    @persistable.setter
    def persistable(self, value):
        # a post-hoc persistable flip changes the executor's state-out
        # surface, so it must invalidate the per-version program analysis
        # cache exactly like an op/var mutation. No-op writes don't bump:
        # program._version keys the jit cache too, and an idempotent
        # re-stamp must not force a recompile.
        if value != self._persistable:
            self._persistable = value
            self.block.program._bump_version()

    # the reference's Variable operator overloads (reference :103-126,
    # python/paddle/fluid/layers/math_op_patch.py)
    def _binary(self, other, op_type, reverse=False):
        from .layers import nn as _nn  # a local import: layers imports this
        return _nn._elementwise_binary(self, other, op_type, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __radd__(self, other):
        return self._binary(other, "elementwise_add", reverse=True)

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __rmul__(self, other):
        return self._binary(other, "elementwise_mul", reverse=True)

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, lod_level={self.lod_level}, "
                f"persistable={self.persistable})")

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type.value,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }


class Parameter(Variable):
    """A persistable trainable Variable (reference framework.py:1118)."""

    def __init__(self, block, name, shape, dtype, trainable=True,
                 regularizer=None, gradient_clip=None, **kw):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, **kw)
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip = gradient_clip
        self.optimize_attr = {"learning_rate": 1.0}


class Operator:
    """One op in a block: type + named input/output slots + attrs.

    Reference: OpDesc (framework.proto:34) / python framework.py:361. Slots map a
    declared name (e.g. "X", "Out") to a list of variable names — the multi-var
    slot form is load-bearing for ops like sum and concat.
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) if isinstance(v, (list, tuple)) else [v]
                       for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) if isinstance(v, (list, tuple)) else [v]
                        for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # normalize Variable objects to names
        for slots in (self.inputs, self.outputs):
            for k, vs in slots.items():
                slots[k] = [v.name if isinstance(v, Variable) else v for v in vs]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return f"Operator({self.type}, inputs={ins}, outputs={outs})"

    def to_dict(self):
        def _attr(v):
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            return v
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": {k: _attr(v) for k, v in self.attrs.items()
                      if not k.startswith("_")},
        }


class Block:
    """An ordered list of ops plus the variables they define.

    Reference: BlockDesc (framework.proto:163) / python framework.py:644. Variable
    lookup recurses into the parent block, which is how sub-blocks of while/cond
    see enclosing scope (reference framework.py _var_recursive).
    """

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: "collections.OrderedDict[str, Variable]" = collections.OrderedDict()
        self.ops: list[Operator] = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # ---- vars ----
    def create_var(self, name=None, **kw):
        if name is None:
            name = unique_name("tmp")
        if name in self.vars:
            # A colliding create_var returns the existing var — but ONLY
            # when the caller's explicit kwargs agree with it. Silently
            # ignoring a conflicting shape/dtype/persistable redefinition
            # is exactly the var-aliasing bug class the verifier exists to
            # catch downstream; fail at the source instead.
            v = self.vars[name]
            conflicts = []
            if kw.get("shape") is not None and v.shape is not None:
                new_shape = tuple(int(s) for s in kw["shape"])
                # -1 is the documented batch wildcard (same rule the
                # verifier's _shape_compatible uses): (-1, 10) and (32, 10)
                # are two annotations of one var, not a redefinition
                if len(new_shape) != len(v.shape) or not all(
                        a == b or a == -1 or b == -1
                        for a, b in zip(new_shape, v.shape)):
                    conflicts.append(f"shape {v.shape} -> {new_shape}")
            if "dtype" in kw and kw["dtype"] is not None \
                    and v.dtype is not None \
                    and getattr(v, "_dtype_explicit", True) \
                    and convert_dtype(kw["dtype"]) != v.dtype:
                # a var first declared WITHOUT a dtype stored the float32
                # default — a later get-or-create naming its true dtype is
                # a refinement, not a conflict (_dtype_explicit, stamped
                # below, records which it was)
                conflicts.append(
                    f"dtype {v.dtype} -> {convert_dtype(kw['dtype'])}")
            if "persistable" in kw \
                    and bool(kw["persistable"]) != bool(v.persistable):
                conflicts.append(
                    f"persistable {v.persistable} -> {kw['persistable']}")
            if conflicts:
                raise ValueError(
                    f"create_var: {name!r} already exists in block "
                    f"{self.idx} with conflicting metadata "
                    f"({'; '.join(conflicts)}); redefining a var under the "
                    "same name silently aliases two different tensors — "
                    "use a unique name or matching metadata")
            return v
        v = Variable(self, name, **kw)
        # whether the dtype annotation was caller-supplied or the float32
        # default — the conflict guard above only trusts explicit ones
        v._dtype_explicit = kw.get("dtype") is not None
        self.vars[name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, name, shape, dtype, **kw):
        # parameters always live in the global (root) block, like the reference
        # (framework.py Block.create_parameter puts them in global_block)
        gb = self.program.global_block()
        p = Parameter(gb, name, shape, dtype, **kw)
        gb.vars[name] = p
        self.program._bump_version()
        return p

    def var(self, name) -> Variable:
        v = self.vars.get(name)
        if v is not None:
            return v
        if self.parent_block is not None:
            return self.parent_block.var(name)
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name):
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def has_var_local(self, name):
        return name in self.vars

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # ---- ops ----
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """A whole model: list of blocks, block 0 is global.

    Reference: ProgramDesc (framework.proto:176) / python framework.py:940.
    ``random_seed`` seeds the startup initializers' generator; ``_version``
    counts mutations.
    """

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._seed_counter = 0  # per-program op seed allocator

    def _bump_version(self):
        self._version += 1

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self, parent_idx=None) -> Block:
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        self._bump_version()
        return b

    def rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test=False) -> "Program":
        """Deep-copy the program (reference framework.py Program.clone).

        With for_test=True, ops flip their 'is_test' attr (dropout / batch_norm
        switch to inference behavior), matching the reference's
        inference_optimize (pybind.cc:292).
        """
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for v in b.vars.values():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[v.name] = nv
            for op in b.ops:
                no = Operator(nb, op.type, copy.deepcopy(op.inputs),
                              copy.deepcopy(op.outputs), copy.deepcopy(op.attrs))
                if for_test and "is_test" in no.attrs:
                    no.attrs["is_test"] = True
                nb.ops.append(no)
            p.blocks.append(nb)
        if not p.blocks:
            p.blocks = [Block(p, 0)]
        p._current_block_idx = 0
        return p

    def to_graphviz(self, block_idx=0):
        """DOT-language dataflow graph of one block (reference
        framework.py:376): op nodes (boxes) wired through var nodes
        (ellipses; parameters double-ringed)."""
        block = self.blocks[block_idx]
        lines = ["digraph G {", "  rankdir=TB;"]
        var_nodes = set()

        def vnode(name):
            if name in var_nodes:
                return
            var_nodes.add(name)
            shape = "doublecircle" if (
                block.has_var(name)
                and isinstance(block.var(name), Parameter)) else "ellipse"
            lines.append(f'  "{name}" [shape={shape}];')

        for i, op in enumerate(block.ops):
            op_id = f"op_{i}_{op.type}"
            lines.append(f'  "{op_id}" [shape=box, style=rounded, '
                         f'label="{op.type}"];')
            for n in op.input_arg_names():
                vnode(n)
                lines.append(f'  "{n}" -> "{op_id}";')
            for n in op.output_arg_names():
                vnode(n)
                lines.append(f'  "{op_id}" -> "{n}";')
        lines.append("}")
        return "\n".join(lines)

    def to_debug_string(self, with_vars=True):
        """Readable IR dump (reference framework.py:406): per block, its
        vars (name, shape, dtype, persistable) and ops (type, inputs ->
        outputs, attrs)."""
        lines = []
        for block in self.blocks:
            parent = f" parent={block.parent_idx}" \
                if block.parent_idx >= 0 else ""
            lines.append(f"block {block.idx}{parent} {{")
            if with_vars:
                for name in sorted(block.vars):
                    v = block.vars[name]
                    tags = []
                    if v.persistable:
                        tags.append("persistable")
                    if isinstance(v, Parameter):
                        tags.append("param")
                    if v.lod_level:
                        tags.append(f"lod={v.lod_level}")
                    tag = (" [" + ",".join(tags) + "]") if tags else ""
                    lines.append(f"  var {name}: shape={v.shape} "
                                 f"dtype={v.dtype}{tag}")
            for op in block.ops:
                ins = ", ".join(f"{k}={v}" for k, v in op.inputs.items()
                                if v)
                outs = ", ".join(f"{k}={v}" for k, v in op.outputs.items()
                                 if v)
                lines.append(f"  op {op.type}({ins}) -> ({outs})"
                             + (f"  attrs={op.attrs}" if op.attrs else ""))
            lines.append("}")
        return "\n".join(lines)

    # ---- serialization (the __model__ analog) ----
    def to_dict(self):
        return {"version": 1, "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                cls = Parameter if vd.get("is_parameter") else Variable
                kw = dict(shape=vd["shape"], dtype=vd["dtype"])
                if cls is Parameter:
                    v = Parameter(b, vd["name"], trainable=vd.get("trainable", True), **kw)
                else:
                    v = Variable(b, vd["name"], lod_level=vd["lod_level"],
                                 persistable=vd["persistable"],
                                 stop_gradient=vd["stop_gradient"],
                                 type=VarType(vd["type"]),
                                 is_data=vd.get("is_data", False), **kw)
                v.lod_level = vd.get("lod_level", 0)
                b.vars[v.name] = v
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    else:
                        attrs[k] = v
                b.ops.append(Operator(b, od["type"], od["inputs"],
                                      od["outputs"], attrs))
            p.blocks.append(b)
        p._current_block_idx = 0
        return p

    @staticmethod
    def from_json(s) -> "Program":
        return Program.from_dict(json.loads(s))


# ---- default program globals (reference framework.py:1180-1250) ----
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    """Context manager swapping the default programs
    (reference framework.py:1251 program_guard)."""
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
