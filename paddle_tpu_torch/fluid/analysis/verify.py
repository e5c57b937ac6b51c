"""``verify_program`` — the structural Program verifier (counterpart of
paddle_tpu/fluid/analysis/verify.py, check for check).

Programs are built in Python and rewritten by transform passes; the
verifier is the validity contract each pass's OUTPUT must satisfy (the
verify_passes flag), so a pass that drops a var or a fusion that breaks a
single-consumer assumption fails HERE with an op-index + block diagnostic
instead of as a KeyError deep inside the executor's op loop.

Checks, in pass order (codes in diagnostics.py):

* registry: every op type registered (PTL001); slot names/arity match the
  op's declared SlotSpec where one exists (PTL002).
* name resolution: every slot name resolves to a declared var, through
  parent-block recursion for while/cond sub-blocks (PTL003).
* dataflow: def-before-use per block (PTL004). Roots are feed/data vars,
  persistable vars (parameters, accumulators — loaded or startup-
  initialized), names written by the startup program, and caller-supplied
  ``feed_names``. Sub-block walks start from the owning op's environment
  plus that op's declared block-local names (a recurrent's step_vars and
  memory carries are bound by the runtime, not by producer ops).
* in_place ops rebind their own input names (PTL008) — the optimizer and
  decode-engine arena convention an in-place-breaking rewrite violates.
* fetch protection: a non-persistable fetch target consumed by an earlier
  op must not be clobbered by a later op that does not read it (PTL010) —
  exactly the hazard memory_optimize's skip set exists to prevent.
* grad pairing: every ``@GRAD`` var has a forward twin (PTL009), and
  agrees with the twin's shape where both are annotated (PTL006).
* shadow inference: each op's registered ``infer_shape`` re-runs into a
  cloned block; disagreement between the recomputed and annotated
  shape/dtype is reported on the producing op (PTL006/PTL007); a raising
  ``infer_shape`` is PTL005 (an error when the op's outputs were
  annotated — i.e. the front end once ran it successfully — else a warning,
  so single-op OpTest programs with unannotated outputs stay quiet).
"""

from __future__ import annotations

from ...core import registry
from ...core.block_walk import SUB_BLOCK_ATTRS
from ...core.types import convert_dtype
from .diagnostics import (Diagnostic, ProgramVerifyError, ERROR, WARNING,
                          UNKNOWN_OP, SLOT_ARITY, UNDEFINED_VAR,
                          USE_BEFORE_DEF, INFER_SHAPE_FAILED, SHAPE_MISMATCH,
                          DTYPE_MISMATCH, IN_PLACE_BROKEN, GRAD_ORPHAN,
                          FETCH_CLOBBER)

GRAD_MARK = "@GRAD"

# (op type, input slot) pairs that lazily ALLOCATE their storage on first
# touch when the read name is rebound by the op's own outputs — the
# tensor-array arena convention: write_to_array reads "Array", allocates
# the [cap, ...] buffer when it is still empty, and writes it back as
# "Out" under the SAME name. Such a read is an allocation site, not a
# use-before-def. Structural (type + slot + rebinding), so it survives
# serialization where the front end's ``is_tensor_array`` mark does not.
_LAZY_INIT_SLOTS = {("write_to_array", "Array")}

# total verify_program invocations — stays flat across steady-state steps
# under executor_verify (the once-per-program-version contract)
_VERIFY_CALLS = 0


def verify_calls():
    return _VERIFY_CALLS


def _block_local_names(op):
    """Names a control-flow op's sub-block receives from the RUNTIME rather
    than from producer ops: a recurrent's per-step slice vars and memory
    carries (control_flow_ops._run_recurrent binds them into the step env)."""
    names = []
    names += list(op.attr("step_vars") or [])
    for m in (op.attr("memories") or []):
        names.append(m[0])
    return names


def _arity_ok(marker, n):
    return {"1": n == 1, "?": n <= 1, "+": n >= 1, "*": True}.get(marker,
                                                                  True)


def _check_slots(op, bidx, i, diags):
    info = registry.get_op_info(op.type)
    spec = info.slots
    if spec is None:
        return
    for slots, declared, kind in ((op.inputs, spec.inputs, "input"),
                                  (op.outputs, spec.outputs, "output")):
        for slot, names in slots.items():
            if not names:
                continue
            if slot not in declared:
                diags.append(Diagnostic(
                    SLOT_ARITY, ERROR,
                    f"unknown {kind} slot {slot!r} (declares "
                    f"{sorted(declared)})", bidx, i, op.type))
            elif not _arity_ok(declared[slot], len(names)):
                diags.append(Diagnostic(
                    SLOT_ARITY, ERROR,
                    f"{kind} slot {slot!r} holds {len(names)} vars, "
                    f"declared arity {declared[slot]!r}", bidx, i, op.type))
        for slot, marker in declared.items():
            if marker in ("1", "+") and not slots.get(slot):
                diags.append(Diagnostic(
                    SLOT_ARITY, ERROR,
                    f"required {kind} slot {slot!r} (arity {marker!r}) is "
                    "missing", bidx, i, op.type))


def _shape_compatible(a, b):
    """Annotated-shape comparison with -1 as a per-dim wildcard."""
    if a is None or b is None:
        return True
    if len(a) != len(b):
        return False
    return all(x == y or x == -1 or y == -1 for x, y in zip(a, b))


def _walk_dataflow(program, bidx, defined, diags, check_ops):
    """Def-before-use walk of one block; returns names written (so the
    caller can mark them defined after the owning control-flow op)."""
    block = program.blocks[bidx]
    written = set()
    for i, op in enumerate(block.ops):
        known = registry.has_op(op.type)
        if check_ops:
            if not known:
                diags.append(Diagnostic(
                    UNKNOWN_OP, ERROR,
                    f"op type {op.type!r} is not registered", bidx, i,
                    op.type))
            else:
                _check_slots(op, bidx, i, diags)
        outs = set(op.output_arg_names())
        lazy_inits = {n for t, slot in _LAZY_INIT_SLOTS if op.type == t
                      for n in op.input(slot) if n in outs}
        for n in op.input_arg_names():
            if not block.has_var(n):
                diags.append(Diagnostic(
                    UNDEFINED_VAR, ERROR,
                    f"input {n!r} is not declared in block {bidx} or any "
                    "parent", bidx, i, op.type, var=n))
            elif n not in defined and n not in lazy_inits:
                diags.append(Diagnostic(
                    USE_BEFORE_DEF, ERROR,
                    f"input {n!r} is read before any op defines it (roots: "
                    "feeds, data vars, persistables, startup writes)",
                    bidx, i, op.type, var=n))
                defined.add(n)  # report each undefined name once per block
        for n in op.output_arg_names():
            if not block.has_var(n):
                diags.append(Diagnostic(
                    UNDEFINED_VAR, ERROR,
                    f"output {n!r} is not declared in block {bidx} or any "
                    "parent", bidx, i, op.type, var=n))
        if known and registry.get_op_info(op.type).in_place:
            # the rebinding contract matters exactly when the op advances
            # persistent state (a param update written to a fresh name
            # never lands in the scope); OpTest-style functional programs
            # feed data vars and may fetch under distinct names
            ins = set(op.input_arg_names())
            stateful = any(block.has_var(n) and block.var(n).persistable
                           for n in ins)
            if stateful:
                for n in op.output_arg_names():
                    if n not in ins:
                        diags.append(Diagnostic(
                            IN_PLACE_BROKEN, ERROR,
                            f"in_place op output {n!r} does not rebind any "
                            "input name (the same-name in/out convention "
                            "optimizer and arena updates rely on — the "
                            "update would never land in the scope)", bidx,
                            i, op.type, var=n))
        for attr in SUB_BLOCK_ATTRS:
            if op.has_attr(attr):
                sub_defined = set(defined)
                sub_defined.update(op.input_arg_names())
                sub_defined.update(op.output_arg_names())
                sub_defined.update(_block_local_names(op))
                sub_written = _walk_dataflow(program, op.attr(attr),
                                             sub_defined, diags, check_ops)
                # sub-block writes are visible to the parent env after the
                # op (conditional_block/while leak their writes)
                defined.update(sub_written)
                written.update(sub_written)
        for n in op.output_arg_names():
            defined.add(n)
            written.add(n)
    return written


def _check_fetch_clobber(program, fetch_names, diags):
    block = program.global_block()
    fetches = {f for f in fetch_names if block.has_var(f)
               and not block.var(f).persistable}
    if not fetches:
        return
    consumed_at = {}  # name -> first op index reading it
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names():
            consumed_at.setdefault(n, i)
    for i, op in enumerate(block.ops):
        if registry.has_op(op.type) and \
                registry.get_op_info(op.type).in_place:
            continue
        reads = set(op.input_arg_names())
        for n in op.output_arg_names():
            if n in fetches and n not in reads \
                    and consumed_at.get(n, len(block.ops)) < i:
                diags.append(Diagnostic(
                    FETCH_CLOBBER, ERROR,
                    f"fetch target {n!r} (consumed by op"
                    f"#{consumed_at[n]}) is overwritten by a later op that "
                    "does not read it — the fetched value would be the "
                    "unrelated redefinition", 0, i, op.type, var=n))


def _check_grad_pairing(program, diags):
    for block in program.blocks:
        for name, v in block.vars.items():
            if GRAD_MARK not in name:
                continue
            fwd = name.split(GRAD_MARK, 1)[0]
            if not fwd or not block.has_var(fwd):
                diags.append(Diagnostic(
                    GRAD_ORPHAN, ERROR,
                    f"grad var {name!r} has no forward twin {fwd!r} in "
                    f"block {block.idx} or any parent", block.idx, None,
                    var=name))
                continue
            fv = block.var(fwd)
            if v.shape is not None and fv.shape is not None \
                    and not _shape_compatible(v.shape, fv.shape):
                diags.append(Diagnostic(
                    SHAPE_MISMATCH, ERROR,
                    f"grad var {name!r} is annotated {v.shape} but its "
                    f"forward twin {fwd!r} is {fv.shape}", block.idx, None,
                    var=name))


def _shadow_infer(program, diags):
    """Re-run every registered infer_shape into a cloned program and report
    disagreements with the annotated vars, localized to the first producing
    op (the shadow keeps the RECOMPUTED annotation, so downstream diffs
    are not re-reported against stale inputs)."""
    shadow = program.clone()
    for bidx, block in enumerate(program.blocks):
        sblock = shadow.blocks[bidx]
        for i, (op, sop) in enumerate(zip(block.ops, sblock.ops)):
            if not registry.has_op(op.type):
                continue
            infer = registry.get_op_info(op.type).infer_shape
            if infer is None:
                continue
            annotated = any(
                block.has_var(n) and block.var(n).shape is not None
                for n in op.output_arg_names())
            try:
                infer(sop, sblock)
            except Exception as e:  # damaged slots land here as KeyError etc
                diags.append(Diagnostic(
                    INFER_SHAPE_FAILED, ERROR if annotated else WARNING,
                    f"infer_shape raised {type(e).__name__}: {e}", bidx, i,
                    op.type))
                continue
            for n in op.output_arg_names():
                if not (block.has_var(n) and sblock.has_var(n)):
                    continue
                v, sv = block.var(n), sblock.var(n)
                if v.shape is not None and sv.shape is not None \
                        and not _shape_compatible(v.shape, sv.shape):
                    diags.append(Diagnostic(
                        SHAPE_MISMATCH, ERROR,
                        f"output {n!r} is annotated {v.shape} but "
                        f"infer_shape computes {sv.shape}", bidx, i,
                        op.type, var=n))
                if v.dtype is not None and sv.dtype is not None \
                        and convert_dtype(v.dtype) != convert_dtype(sv.dtype):
                    diags.append(Diagnostic(
                        DTYPE_MISMATCH, ERROR,
                        f"output {n!r} is annotated {v.dtype} but "
                        f"infer_shape computes {sv.dtype}", bidx, i,
                        op.type, var=n))


def verify_program(program, feed_names=(), fetch_names=(),
                   startup_program=None, pass_name=None,
                   raise_on_error=True):
    """Verify ``program``; returns the list of Diagnostics (errors and
    warnings). With ``raise_on_error`` (default), any ERROR-severity
    finding raises :class:`ProgramVerifyError` carrying all of them and
    ``pass_name`` (the transform whose output was rejected)."""
    global _VERIFY_CALLS
    _VERIFY_CALLS += 1
    diags: list[Diagnostic] = []

    roots = set(feed_names)
    for name, v in program.global_block().vars.items():
        if v.persistable or v.is_data:
            roots.add(name)
    if startup_program is not None:
        from ...core.block_walk import written_names
        roots.update(written_names(startup_program, 0))

    _walk_dataflow(program, 0, set(roots), diags, check_ops=True)
    _check_fetch_clobber(program, fetch_names, diags)
    _check_grad_pairing(program, diags)
    _shadow_infer(program, diags)

    diags.sort(key=lambda d: (d.severity != ERROR, d.block_idx,
                              -1 if d.op_idx is None else d.op_idx))
    if raise_on_error and any(d.severity == ERROR for d in diags):
        raise ProgramVerifyError(diags, pass_name=pass_name)
    return diags


def verify_pass_output(program, pass_name, feed_names=(), fetch_names=(),
                       startup_program=None):
    """The transform-pass hook: no-op unless the ``verify_passes`` flag is
    set, then a full verify whose failure names the pass."""
    from ...core.flags import get_flag
    if not get_flag("verify_passes"):
        return None
    return verify_program(program, feed_names=feed_names,
                          fetch_names=fetch_names,
                          startup_program=startup_program,
                          pass_name=pass_name)
