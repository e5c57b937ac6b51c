"""``lint_program`` — quality rules over a Program (PTL1xx warnings;
counterpart of paddle_tpu/fluid/analysis/lint.py, rule for rule).

Where the verifier (verify.py) rejects programs that cannot run correctly,
lint flags programs that run but waste work or carry latent hazards — the
compiler-warning tier. Every rule has a stable code, a severity, and
op-index/block provenance; rules never mutate the program.

Rules:

* PTL101 dead-op: an op none of whose outputs is ever consumed by a later
  op (any block), fetched, persistable, or a data var — a transform left
  work behind (e.g. a fusion pass that forgot to strip the replaced chain).
* PTL102 unused-var: a declared non-persistable, non-data var no op reads
  or writes — pruning removed the ops but left the declaration.
* PTL103 write-after-write: a var written twice where the later writer does
  not read it (and neither op is in_place) — the duplicate-output hazard;
  legitimate for memory_optimize's name reuse, which is why this is a
  warning and not a verifier error.
* PTL104 sparse-densified: an ``is_sparse`` lookup_table whose table grad
  is consumed by a non-rowwise op (sum/scale/clip...) — the O(touched-rows)
  wire contract silently densifies to the full table.
* PTL105 fp16-boundary: an op consuming a mix of fp16 and fp32 float
  operands (cast ops exempt — mixing is their job). The hazard class of
  ``pserver_wire_dtype=fp16``/amp programs: a missing cast upcasts per-op
  instead of at the declared boundary.
* PTL106 retrace-hazard: an op whose ``shape`` attr bakes a concrete batch
  dimension over an input declared with a -1 (dynamic) batch — defeats the
  serving bucket contract (the reference retraces per distinct batch; the
  port reruns the op loop, but the baked shape still breaks other
  batches).
"""

from __future__ import annotations

from ...core import registry
from ...core.types import convert_dtype
from .diagnostics import (Diagnostic, WARNING, DEAD_OP, UNUSED_VAR,
                          WRITE_AFTER_WRITE, SPARSE_DENSIFIED, FP16_BOUNDARY,
                          RETRACE_HAZARD)

# ops that consume a sparse (SelectedRows-style) grad rowwise without
# densifying it: the optimizer rules with a sparse branch
_SPARSE_SAFE = {"sgd", "momentum", "adam", "fused_sgd", "fused_momentum",
                "fused_adam", "split_selected_rows", "split_ids"}

_FLOAT16 = {"float16", "bfloat16"}
_FLOAT_WIDE = {"float32", "float64"}


def _is_in_place(op):
    return registry.has_op(op.type) and registry.get_op_info(op.type).in_place


def _all_ops(program):
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            yield block, i, op


def _consumers(program):
    used = set()
    for _, _, op in _all_ops(program):
        used.update(op.input_arg_names())
    return used


def _lint_dead_ops(program, fetch_names, diags):
    used = _consumers(program)
    protected = set(fetch_names)
    block = program.global_block()
    for i, op in enumerate(block.ops):
        outs = op.output_arg_names()
        if not outs or _is_in_place(op):
            continue
        live = False
        for n in outs:
            if n in used or n in protected:
                live = True
                break
            if block.has_var(n):
                v = block.var(n)
                if v.persistable or v.is_data:
                    live = True
                    break
        if not live:
            diags.append(Diagnostic(
                DEAD_OP, WARNING,
                f"no output of this op ({outs}) is consumed, fetched, or "
                "persistable — dead work a transform left behind",
                0, i, op.type))


def _lint_unused_vars(program, fetch_names, diags):
    touched = set(fetch_names)
    for _, _, op in _all_ops(program):
        touched.update(op.input_arg_names())
        touched.update(op.output_arg_names())
    for block in program.blocks:
        for name, v in block.vars.items():
            if name in touched or v.persistable or v.is_data:
                continue
            diags.append(Diagnostic(
                UNUSED_VAR, WARNING,
                f"var {name!r} is declared but no op touches it",
                block.idx, None, var=name))


def _lint_waw(program, diags):
    block = program.global_block()
    writers = {}  # name -> first writer idx
    for i, op in enumerate(block.ops):
        reads = set(op.input_arg_names())
        for n in op.output_arg_names():
            if n in writers and n not in reads and not _is_in_place(op):
                diags.append(Diagnostic(
                    WRITE_AFTER_WRITE, WARNING,
                    f"var {n!r} (first written by op#{writers[n]}) is "
                    "overwritten without being read — duplicate-output "
                    "write-after-write hazard", 0, i, op.type, var=n))
            writers.setdefault(n, i)


def _lint_sparse(program, diags):
    from ..framework import grad_var_name
    block = program.global_block()
    sparse_tables = {op.input("W")[0] for op in block.ops
                     if op.type == "lookup_table"
                     and op.attr("is_sparse", False) and op.input("W")}
    if not sparse_tables:
        return
    for i, op in enumerate(block.ops):
        if op.type in _SPARSE_SAFE or op.type == "lookup_table_grad":
            continue
        for n in op.input_arg_names():
            for w in sparse_tables:
                if n == grad_var_name(w):
                    diags.append(Diagnostic(
                        SPARSE_DENSIFIED, WARNING,
                        f"grad of is_sparse table {w!r} is consumed by "
                        f"{op.type!r}, which densifies the O(touched-rows) "
                        "sparse rows to the full table", 0, i, op.type,
                        var=n))


def _lint_fp16(program, diags):
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            if op.type == "cast":
                continue
            dtypes = set()
            for n in op.input_arg_names():
                if block.has_var(n):
                    d = block.var(n).dtype
                    if d is not None:
                        dtypes.add(convert_dtype(d))
            if dtypes & _FLOAT16 and dtypes & _FLOAT_WIDE:
                diags.append(Diagnostic(
                    FP16_BOUNDARY, WARNING,
                    f"op consumes mixed {sorted(dtypes & _FLOAT16)} and "
                    f"{sorted(dtypes & _FLOAT_WIDE)} operands without a "
                    "cast at the boundary", block.idx, i, op.type))


def _lint_retrace(program, diags):
    for block in program.blocks:
        for i, op in enumerate(block.ops):
            shape = op.attr("shape")
            if not isinstance(shape, (list, tuple)) or len(shape) < 2:
                continue
            lead = shape[0]
            if not isinstance(lead, int) or lead in (-1, 0, 1):
                continue
            ins = op.input_arg_names()
            if not ins:
                continue
            first = ins[0]
            if block.has_var(first):
                v = block.var(first)
                if v.shape and v.shape[0] == -1:
                    diags.append(Diagnostic(
                        RETRACE_HAZARD, WARNING,
                        f"attr shape={list(shape)} bakes concrete batch "
                        f"{lead} over input {first!r} declared with a -1 "
                        "batch dim — every distinct runtime batch "
                        "recompiles (defeats the serving bucket contract)",
                        block.idx, i, op.type))


def lint_program(program, fetch_names=()):
    """Run every lint rule; returns a list of WARNING Diagnostics sorted by
    (block, op index). Never raises on findings."""
    diags: list[Diagnostic] = []
    _lint_dead_ops(program, fetch_names, diags)
    _lint_unused_vars(program, fetch_names, diags)
    _lint_waw(program, diags)
    _lint_sparse(program, diags)
    _lint_fp16(program, diags)
    _lint_retrace(program, diags)
    diags.sort(key=lambda d: (d.block_idx,
                              -1 if d.op_idx is None else d.op_idx, d.code))
    return diags
