"""Memory-optimization transpiler: liveness-based variable reuse and early
release (counterpart of paddle_tpu/fluid/memory_optimization_transpiler.py,
``memory_optimize`` :158, ``release_memory`` :193; Paddle's
python/paddle/fluid/memory_optimization_transpiler.py).

A straight-line liveness analysis over block 0 that (a) renames a freshly
defined temporary onto a dead one, so the two share one name, and (b)
inserts ``delete_var`` ops at each variable's death point. The reference
says the passes matter only for an eager interpreter (its docstring): its
jit path leaves the reuse to XLA's buffer assignment. The port's Executor
is exactly such an interpreter: a run's environment maps names to torch
tensors, and an intermediate stays referenced until the block ends unless
its name is rebound (a rename) or dropped (``delete_var``), whereupon the
caching allocator takes its memory back. So on the card these passes lower
a step's peak device memory.

The rules are the reference's, one for one:

* reuse is at the name level, and a rename needs an EXACT declared shape
  and dtype match at every ``level`` (``level`` is accepted for API parity
  and changes nothing);
* ops carrying control-flow sub-blocks are barriers: every name their
  sub-blocks read or write is left alone;
* fetch targets stay addressable: pass them as ``fetch_list`` (or in
  ``skip_opt_set``);
* only data vars are optimized: declared in the block, not persistable,
  of known shape, not ragged.
"""

from __future__ import annotations

from ..core.block_walk import SUB_BLOCK_ATTRS, free_reads, written_names


def _liveness(ops):
    """uses/defs per op and the straight-line backward liveness fixpoint
    (reference _liveness, Paddle's _dataflow_analyze)."""
    n = len(ops)
    uses = [set(op.input_arg_names()) for op in ops]
    defs = [set(op.output_arg_names()) for op in ops]
    live_in = [set() for _ in range(n)]
    live_out = [set() for _ in range(n)]
    changed = True
    while changed:
        changed = False
        for i in range(n - 1, -1, -1):
            lo = set(live_in[i + 1]) if i + 1 < n else set()
            li = uses[i] | (lo - defs[i])
            if lo != live_out[i] or li != live_in[i]:
                live_out[i], live_in[i] = lo, li
                changed = True
    return uses, defs, live_in, live_out


def _protected_names(skip_opt_set, fetch_list):
    """The user's fetch-protection surface: the fetch targets the
    post-pass verify holds the PTL010 clobber check to."""
    names = set(skip_opt_set or ())
    names.update(f if isinstance(f, str) else f.name
                 for f in fetch_list or ())
    return sorted(names)


def _has_sub_block(op):
    return any(op.has_attr(a) for a in SUB_BLOCK_ATTRS)


def _build_skip_set(program, block, skip_opt_set, fetch_list):
    skip = set(_protected_names(skip_opt_set, fetch_list))
    for op in block.ops:
        if _has_sub_block(op):
            # control-flow barrier: its args and everything its sub-blocks
            # touch stay untouched
            skip.update(op.input_arg_names())
            skip.update(op.output_arg_names())
            for a in SUB_BLOCK_ATTRS:
                if op.has_attr(a):
                    sub = op.attr(a)
                    skip.update(free_reads(program, sub))
                    skip.update(written_names(program, sub))
    return skip


def _optimizable(block, name, skip):
    """Data vars only: declared in the block, not persistable, of known
    shape, not ragged, not skipped."""
    if name in skip or not block.has_var(name):
        return False
    v = block.var(name)
    if v.persistable or (v.lod_level or 0) > 0:
        return False
    return v.shape is not None


def _shapes_compatible(x, cache, level):
    """An exact declared-shape match at every level (the module
    docstring); ``level`` is accepted for API parity."""
    del level
    return tuple(x.shape) == tuple(cache.shape)


def memory_optimize(program, print_log=False, level=0, skip_opt_set=None,
                    fetch_list=None):
    """Rename each freshly defined temporary onto a dead one of the same
    declared shape and dtype. Mutates ``program`` in place and returns the
    number of renames."""
    block = program.global_block()
    ops = block.ops
    skip = _build_skip_set(program, block, skip_opt_set, fetch_list)
    uses, defs, live_in, live_out = _liveness(ops)

    # names used or defined at or after each index: a cache var is never
    # touched again after it is renamed onto
    n = len(ops)
    touched_after = [set() for _ in range(n + 1)]
    for i in range(n - 1, -1, -1):
        touched_after[i] = touched_after[i + 1] | uses[i] | defs[i]

    pool = []  # [(name, Variable)] dead vars open for reuse, first in first
    renames = 0
    for i, op in enumerate(ops):
        if _has_sub_block(op):
            continue
        if pool:
            for x in sorted(defs[i]):
                if x in uses[i] or not _optimizable(block, x, skip):
                    continue
                xv = block.var(x)
                for j, (cname, cv) in enumerate(pool):
                    if str(cv.dtype) != str(xv.dtype):
                        continue
                    if not _shapes_compatible(xv, cv, level):
                        continue
                    if cname in touched_after[i]:
                        # covers a redefinition of cname, cname == x too
                        continue
                    pool.pop(j)
                    if print_log:
                        print(f"memory_optimize: reuse {cname} <- {x} "
                              f"(op {i} {op.type})")
                    _rename_from(ops, i, x, cname)
                    for k in range(i, n):
                        for s in (uses[k], defs[k], live_in[k], live_out[k],
                                  touched_after[k]):
                            if x in s:
                                s.discard(x)
                                s.add(cname)
                    renames += 1
                    break
        # the vars dying at this op join the pool
        for name in sorted(live_in[i] - live_out[i] - defs[i]):
            if _optimizable(block, name, skip):
                pool.append((name, block.var(name)))
    program._bump_version()
    # verify_passes: a rename must never clobber a protected fetch or
    # break the dataflow
    from .analysis import verify_pass_output
    verify_pass_output(program, "memory_optimize",
                       fetch_names=_protected_names(skip_opt_set, fetch_list))
    return renames


def _rename_from(ops, begin, old, new):
    for op in ops[begin:]:
        for slots in (op.inputs, op.outputs):
            for k, names in slots.items():
                slots[k] = [new if nm == old else nm for nm in names]


def release_memory(program, skip_opt_set=None, fetch_list=None):
    """Insert a ``delete_var`` op at each temporary's death point, so the
    Executor frees it mid-block. Mutates ``program`` in place; returns the
    number of ops added."""
    block = program.global_block()
    ops = list(block.ops)
    skip = _build_skip_set(program, block, skip_opt_set, fetch_list)
    _, defs, live_in, live_out = _liveness(ops)

    inserted = 0
    for i in range(len(ops) - 1, -1, -1):
        if _has_sub_block(ops[i]):
            continue
        dead = sorted(
            name for name in (live_in[i] | defs[i]) - live_out[i]
            if _optimizable(block, name, skip))
        if dead:
            block.insert_op(i + 1, "delete_var", inputs={"X": dead},
                            outputs={})
            inserted += 1
    program._bump_version()
    from .analysis import verify_pass_output
    verify_pass_output(program, "release_memory",
                       fetch_names=_protected_names(skip_opt_set, fetch_list))
    return inserted


__all__ = ["memory_optimize", "release_memory"]
