"""IR-level reverse-mode autodiff: ``append_backward`` (counterpart of
paddle_tpu/fluid/backward.py:48-187).

Walk the block's ops in reverse from the loss, ask each op's grad maker for
grad op specs (``core.registry.OpInfo.grad``), zero-fill output grads a grad
op reads but nothing produced (``fill_zeros_like``), rename-and-sum repeated
grads (an ``overwrite_slots`` slot replaces the earlier grad instead, the
in-place loop-state contract of ``while_grad`` and
``write_to_array_grad``), and prune ops that do not reach the loss. The
grad ops are appended
to the same block, so one ``Executor.run`` runs forward, backward and the
optimizer ops after them. Under the ``verify_passes`` flag the result is
re-verified (fluid/analysis, as reference backward.py:185-186).
"""

from __future__ import annotations

from .framework import Variable, Parameter, grad_var_name, unique_name
from ..core import registry


def _op_path(block, loss_name, start_idx=None):
    """Indices of ops that contribute to ``loss_name``."""
    needed = {loss_name}
    path = []
    ops = block.ops if start_idx is None else block.ops[:start_idx]
    for i in reversed(range(len(ops))):
        op = ops[i]
        if any(o in needed for o in op.output_arg_names()):
            path.append(i)
            needed.update(op.input_arg_names())
    return set(path)


def _create_grad_var(block, fwd_name, grad_name):
    if block.has_var_local(grad_name):
        return block.vars[grad_name]
    if block.has_var(fwd_name):
        fv = block.var(fwd_name)
        return block.create_var(name=grad_name, shape=fv.shape,
                                dtype=fv.dtype, lod_level=fv.lod_level)
    return block.create_var(name=grad_name)


def _is_param(block, name):
    try:
        return isinstance(block.var(name), Parameter)
    except KeyError:
        return False


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append grad ops for ``loss`` to its program; returns
    [(param, grad_var)]. ``loss`` is a scalar variable of the root block."""
    if not isinstance(loss, Variable):
        raise TypeError(f"append_backward: loss must be a Variable, got "
                        f"{type(loss).__name__}")
    block = loss.block
    program = block.program
    stop = {name for name, v in block.vars.items() if v.stop_gradient}
    stop |= set(no_grad_set or ())

    # d(loss)/d(loss) = 1
    loss_grad = grad_var_name(loss.name)
    _create_grad_var(block, loss.name, loss_grad)
    block.append_op("fill_constant", outputs={"Out": [loss_grad]},
                    attrs={"shape": list(loss.shape or ()), "value": 1.0,
                           "dtype": loss.dtype or "float32"})
    path = _op_path(block, loss.name, start_idx=len(block.ops) - 1)
    produced = {loss_grad}

    # names that depend on a trainable parameter: an op on the path with no
    # grad maker must not silently cut their gradient chain
    derived = {p.name for p in program.global_block().all_parameters()
               if p.trainable} - stop
    for i in sorted(path):
        op = block.ops[i]
        if any(n in derived for n in op.input_arg_names()):
            derived.update(n for n in op.output_arg_names() if n not in stop)

    for i in sorted(path, reverse=True):
        op = block.ops[i]
        info = registry.get_op_info(op.type)
        outs = op.output_arg_names()
        # an op whose every output is an explicit stop_gradient var is pruned
        if outs and all(n in stop and not _is_param(block, n) for n in outs):
            continue
        if not any(grad_var_name(n) in produced for n in outs):
            continue
        if info.grad is None:
            if any(n in derived for n in op.input_arg_names()):
                raise RuntimeError(
                    f"op {op.type!r} (#{i} in block {block.idx}) lies on the "
                    f"gradient path of {loss.name!r} but registers no grad "
                    "maker; parameters feeding it would silently stop "
                    "training. Mark its inputs stop_gradient=True or use an "
                    "op with a gradient.")
            continue
        specs = info.grad(op)
        # output grads a grad op reads but nothing produced get zeros
        spec_inputs = {n for spec in specs
                       for names in spec.inputs.values() for n in names}
        for names in op.outputs.values():
            for n in names:
                g = grad_var_name(n)
                if g not in produced and g in spec_inputs:
                    _create_grad_var(block, n, g)
                    block.append_op("fill_zeros_like", inputs={"X": [n]},
                                    outputs={"Out": [g]})
                    produced.add(g)

        for spec in specs:
            # rename-and-sum for a grad produced twice, also within one
            # spec; an overwrite slot (reference :137-151) replaces instead
            renames = []
            spec_seen = set()
            for slot, names in spec.outputs.items():
                new_names = []
                for n in names:
                    fwd = n[:-len(registry.GRAD_SUFFIX)] \
                        if n.endswith(registry.GRAD_SUFFIX) else n
                    if (n in produced or n in spec_seen) \
                            and slot not in spec.overwrite_slots:
                        tmp = unique_name(n + "@RENAME")
                        _create_grad_var(block, fwd, tmp)
                        renames.append((n, tmp))
                        new_names.append(tmp)
                    else:
                        _create_grad_var(block, fwd, n)
                        new_names.append(n)
                    spec_seen.add(n)
                spec.outputs[slot] = new_names
            block.append_op(spec.type, spec.inputs, spec.outputs, spec.attrs)
            for names in spec.outputs.values():
                produced.update(names)
            for canonical, tmp in renames:
                block.append_op("sum", inputs={"X": [canonical, tmp]},
                                outputs={"Out": [canonical]})

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.global_block().all_parameters()
                  if p.trainable]
    result = [(p, block.var(grad_var_name(p.name))) for p in params
              if grad_var_name(p.name) in produced]

    # verify_passes: the appended-grad program must still be structurally
    # valid (raises ProgramVerifyError naming this pass)
    from .analysis import verify_pass_output
    verify_pass_output(program, "append_backward")
    return result


__all__ = ["append_backward"]
