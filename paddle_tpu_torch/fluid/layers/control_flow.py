"""Control-flow layer functions (counterpart of paddle_tpu/fluid/layers/
control_flow.py): increment, the comparisons, tensor arrays
(create_array, array_write, array_read, array_length), While (with
``max_iters``), Switch, StaticRNN and DynamicRNN (one ``recurrent`` /
``dynamic_recurrent`` op over a step block), the beam-search layers
(beam_search, batch_gather, beam_search_decode), IfElse and the debug
Print. The ops they build run as loops over their sub-blocks
(ops/control_flow_ops.py)."""

from __future__ import annotations

import contextlib

from ..framework import unique_name
from ..layer_helper import LayerHelper


def _is_float_dtype(dtype):
    return dtype is None or str(dtype).startswith("float") \
        or str(dtype) == "bfloat16"


def _free_float_reads(program, sub_idx, locals_):
    """Float-typed outer vars a sub-block reads before writing — the grad
    surface of a control-flow op: weights AND float tensor arrays (values
    staged through array_write from trainable computations must backprop;
    write_to_array_grad routes the array grad back to its producers)."""
    from ...core.block_walk import free_reads

    blk = program.blocks[sub_idx]
    return [n for n in free_reads(program, sub_idx, locals_)
            if blk.has_var(n) and _is_float_dtype(blk.var(n).dtype)]


def _block_written_names(program, sub_idx):
    from ...core.block_walk import written_names
    return written_names(program, sub_idx)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_tmp_variable(x.dtype, shape=x.shape)
    helper.append_op("increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"step": value})
    return out


def less_than(x, y, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_tmp_variable("bool", shape=x.shape)
    helper.append_op("less_than", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]})
    return cond


def create_array(dtype, cap=64):
    """A tensor-array variable (reference :59). ``cap`` bounds the number
    of steps: the first write_to_array allocates a [cap, ...] buffer."""
    helper = LayerHelper("create_array")
    var = helper.block.create_var(name=unique_name("array"), dtype=dtype)
    var.is_tensor_array = True
    var.array_cap = cap
    return var


def array_write(x, i, array=None, cap=64):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype, cap=cap)
    # build-time element metadata so array_read outputs have shapes
    if getattr(array, "elem_shape", None) is None:
        array.elem_shape = x.shape
        array.elem_dtype = x.dtype
    helper.append_op("write_to_array",
                     inputs={"X": [x.name], "I": [i.name],
                             "Array": [array.name]},
                     outputs={"Out": [array.name]},
                     attrs={"cap": getattr(array, "array_cap", cap)})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(
        getattr(array, "elem_dtype", "float32"),
        shape=getattr(array, "elem_shape", None))
    helper.append_op("read_from_array",
                     inputs={"X": [array.name], "I": [i.name]},
                     outputs={"Out": [out.name]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable("int64", shape=(1,))
    helper.append_op("array_length", inputs={"X": [array.name]},
                     outputs={"Out": [out.name]})
    return out


class While:
    """while_op builder (reference :107):

        cond = layers.less_than(i, limit)
        w = layers.While(cond)
        with w.block():
            ...
            layers.less_than(i, limit, cond=cond)  # update condition

    ``max_iters`` stops the loop after that many iterations even while the
    condition holds, and bounds while_grad's replay; without it while_grad
    derives a bound from the counter pattern, or append_backward raises.
    """

    def __init__(self, cond, name=None, max_iters=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_iters = max_iters

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_idx = program.current_block().idx
        sub = program.create_block()
        yield
        program.rollback()
        parent = program.blocks[parent_idx]
        written = _block_written_names(program, sub.idx)
        # loop state: block-written vars that pre-exist outside the loop
        carried = [n for n in written if parent.has_var(n)]
        if self.cond_var.name not in carried:
            carried.append(self.cond_var.name)
        free_vars = [n for n in _free_float_reads(program, sub.idx, set())
                     if n not in carried]
        # pre-loop state snapshots consumed by while_grad (the grad op runs
        # after the loop has rebound the carried names in place). Names are
        # unique per While op: two loops carrying the same var must not
        # clobber each other's snapshots.
        preloop = []
        for n in carried:
            cv = parent.var(n)
            pv = parent.create_var(name=unique_name(n + "@PRELOOP"),
                                   dtype=cv.dtype, shape=cv.shape,
                                   lod_level=cv.lod_level)
            preloop.append(pv.name)
        parent.append_op(
            "while",
            inputs={"Condition": [self.cond_var.name], "Carried": carried,
                    "FreeVars": free_vars},
            outputs={"Out": carried, "PreLoop": preloop},
            attrs={"sub_block": sub.idx,
                   "carried": carried,
                   "diff_vars": free_vars,
                   "max_iters": self.max_iters})


class Switch:
    """Scalar-guarded case chain (reference control_flow.py Switch); each
    case body runs under a conditional_block with select semantics."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._not_prev = None  # conjunction of negated prior conditions

    @contextlib.contextmanager
    def case(self, condition):
        helper = self.helper
        if self._not_prev is not None:
            combined = helper.create_tmp_variable("bool")
            helper.append_op("logical_and",
                             inputs={"X": [self._not_prev.name],
                                     "Y": [condition.name]},
                             outputs={"Out": [combined.name]})
            cond = combined
        else:
            cond = condition
        notc = helper.create_tmp_variable("bool")
        helper.append_op("logical_not", inputs={"X": [condition.name]},
                         outputs={"Out": [notc.name]})
        if self._not_prev is None:
            self._not_prev = notc
        else:
            acc = helper.create_tmp_variable("bool")
            helper.append_op("logical_and",
                             inputs={"X": [self._not_prev.name],
                                     "Y": [notc.name]},
                             outputs={"Out": [acc.name]})
            self._not_prev = acc

        program = helper.main_program
        parent_idx = program.current_block().idx
        sub = program.create_block()
        yield
        program.rollback()
        program.blocks[parent_idx].append_op(
            "conditional_block", inputs={"Cond": [cond.name]}, outputs={},
            attrs={"sub_block": sub.idx})

    @contextlib.contextmanager
    def default(self):
        assert self._not_prev is not None, "default() before any case()"
        program = self.helper.main_program
        parent_idx = program.current_block().idx
        sub = program.create_block()
        yield
        program.rollback()
        program.blocks[parent_idx].append_op(
            "conditional_block", inputs={"Cond": [self._not_prev.name]},
            outputs={}, attrs={"sub_block": sub.idx})


class _RNNBase:
    """Shared builder for StaticRNN / DynamicRNN: collects step inputs,
    memories and outputs, then appends one recurrent/dynamic_recurrent op."""

    OP_TYPE = "recurrent"
    IN_RNN_BLOCK = False

    def __init__(self, name=None):
        self.helper = LayerHelper(self.OP_TYPE, name=name)
        self.step_inputs = []   # outer var names
        self.step_vars = []     # block-local per-step names
        self.memories = []      # (mem_name, new_name)
        self.mem_inits = {}     # mem_name -> init var name
        self.outputs = []
        self.out_vars = []
        self._sub_idx = None
        self._parent_idx = None
        self._status = "outside"

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent_idx = program.current_block().idx
        sub = program.create_block()
        self._sub_idx = sub.idx
        self._status = "in_block"
        yield
        program.rollback()
        self._status = "done"
        self._append_op()

    def _free_float_vars(self):
        """Outer float vars the step block reads beyond step inputs/memories
        — the weights. They join the grad surface (attr diff_vars) so
        recurrent_grad produces their gradients (the reference's backward
        sub-block recursion collects them the same way,
        python backward.py:273)."""
        locals_ = set(self.step_vars) | {m for m, _ in self.memories} \
            | set(self.mem_inits.keys())
        return _free_float_reads(self.helper.main_program, self._sub_idx,
                                 locals_)

    def _append_op(self):
        program = self.helper.main_program
        parent = program.blocks[self._parent_idx]
        sub = program.blocks[self._sub_idx]
        free_vars = self._free_float_vars()
        is_dyn = self.OP_TYPE == "dynamic_recurrent"

        # declare stacked outputs with real metadata (shape [b, T, feat] from
        # the outer input and the block-local output var)
        outer0 = parent.var(self.step_inputs[0]) if self.step_inputs else None
        stacked_names, self._stacked_vars = [], []
        for o in self.outputs:
            ov = sub.var(o) if sub.has_var(o) else None
            feat = tuple(ov.shape[1:]) if ov is not None and ov.shape else None
            if is_dyn:
                # LoD build-shape convention is the reference's FLAT rows
                # form [-1, *feat] (lod_level carries the ragged time dim);
                # downstream fc/softmax flatten from dim 1
                shape = ((-1,) + feat) if feat is not None else None
            else:
                bt = tuple(outer0.shape[:2]) \
                    if outer0 is not None and outer0.shape is not None \
                    else None
                shape = bt + feat if (feat is not None and bt is not None) \
                    else None
            sv = parent.create_var(
                name=o + "@STACKED", shape=shape,
                dtype=(ov.dtype if ov is not None else None) or "float32",
                lod_level=1 if is_dyn else 0)
            stacked_names.append(sv.name)
            self._stacked_vars.append(sv)
        final_names = []
        for mem, _new in self.memories:
            init = parent.var(self.mem_inits[mem]) \
                if parent.has_var(self.mem_inits[mem]) else None
            parent.create_var(
                name=mem + "@FINAL",
                shape=init.shape if init is not None else None,
                dtype=(init.dtype if init is not None else None) or "float32")
            final_names.append(mem + "@FINAL")

        # grad surface: float step inputs + memory inits + free weights
        diff_vars = []
        for n in list(self.step_inputs) + list(self.mem_inits.values()) \
                + free_vars:
            if n in diff_vars:
                continue
            v = parent.var(n) if parent.has_var(n) else None
            if v is not None and not _is_float_dtype(v.dtype):
                continue
            diff_vars.append(n)

        parent.append_op(
            self.OP_TYPE,
            inputs={"Inputs": self.step_inputs,
                    "MemInits": list(self.mem_inits.values()),
                    "FreeVars": free_vars},
            outputs={"Stacked": stacked_names, "FinalMems": final_names},
            attrs={"sub_block": self._sub_idx,
                   "step_inputs": list(self.step_inputs),
                   "step_vars": list(self.step_vars),
                   "memories": [list(m) for m in self.memories],
                   "mem_inits": {k: v for k, v in self.mem_inits.items()},
                   "outputs": list(self.outputs),
                   "diff_vars": diff_vars})

    # -- inside-block API --
    def step_input(self, x):
        assert self._status == "in_block", "step_input outside rnn.step()"
        block = self.helper.main_program.current_block()
        # per-step slice is [batch, *feat]: a dense StaticRNN input is built
        # [batch, T, *feat] (drop the time dim); a ragged DynamicRNN input's
        # build shape is the reference's flat [-1, *feat] rows form, which
        # already matches the slice
        if x.shape is None:
            shape = None
        elif self.OP_TYPE == "dynamic_recurrent":
            shape = tuple(x.shape)
        else:
            shape = (x.shape[0],) + tuple(x.shape[2:])
        iv = block.create_var(name=unique_name(x.name + "@step"),
                              dtype=x.dtype, shape=shape)
        self.step_inputs.append(x.name)
        self.step_vars.append(iv.name)
        return iv

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        assert self._status == "in_block", "memory outside rnn.step()"
        if init is None:
            assert shape is not None
            from . import tensor as tensor_layers
            program = self.helper.main_program
            # build the init in the PARENT block (it is loop state)
            cur = program._current_block_idx
            program._current_block_idx = self._parent_idx
            init = tensor_layers.fill_constant(shape=shape, dtype=dtype,
                                               value=value)
            program._current_block_idx = cur
        block = self.helper.main_program.current_block()
        mem = block.create_var(name=unique_name("rnn_memory"),
                               dtype=init.dtype, shape=init.shape)
        self.mem_inits[mem.name] = init.name
        return mem

    def update_memory(self, mem, new):
        assert self._status == "in_block"
        self.memories.append((mem.name, new.name))

    def step_output(self, o):
        assert self._status == "in_block"
        self.outputs.append(o.name)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    # -- outside-block API --
    def __call__(self):
        """Stacked step outputs (reference StaticRNN.__call__ /
        DynamicRNN.__call__) — the vars were declared (with dtype/shape) as
        the recurrent op's Stacked outputs in _append_op."""
        outs = list(self._stacked_vars)
        return outs[0] if len(outs) == 1 else outs

    def final_memory(self, mem):
        parent = self.helper.main_program.blocks[self._parent_idx]
        return parent.var(mem.name + "@FINAL")


class StaticRNN(_RNNBase):
    """Fixed-length RNN over dense [batch, T, feat] inputs; the block runs
    once per timestep (reference :382). memory() records an init var and
    update_memory() the per-step rebinding; the recurrent op carries
    them."""
    OP_TYPE = "recurrent"


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                name=None):
    """One beam-search step over dense [batch, beam] state (reference
    layers beam_search → beam_search_op.h). Returns (selected_ids,
    selected_scores, parent_idx); parent_idx replaces the reference's
    LoD-encoded beam provenance."""
    helper = LayerHelper("beam_search", name=name)
    # int32, what the dense op emits (and the reference package's
    # declaration; upstream Paddle declares int64)
    sel_ids = helper.create_tmp_variable("int32")
    sel_scores = helper.create_tmp_variable(scores.dtype)
    parents = helper.create_tmp_variable("int32")
    helper.append_op(
        "beam_search",
        inputs={"pre_ids": [pre_ids.name], "pre_scores": [pre_scores.name],
                "ids": [ids.name], "scores": [scores.name]},
        outputs={"selected_ids": [sel_ids.name],
                 "selected_scores": [sel_scores.name],
                 "parent_idx": [parents.name]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return sel_ids, sel_scores, parents


def batch_gather(x, index):
    """out[i, j] = x[i, index[i, j]] (beam-state reordering by parent_idx)."""
    helper = LayerHelper("batch_gather")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("batch_gather",
                     inputs={"X": [x.name], "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def beam_search_decode(ids, parents, scores, end_id, name=None):
    """Backtrack a finished beam search: ``ids``/``parents`` are tensor
    arrays written once per step, ``scores`` the final accumulated scores.
    Returns (sentence_ids LoD var of batch*beam ragged sequences,
    sentence_scores)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent_ids = helper.create_tmp_variable("int32", lod_level=1)
    sent_scores = helper.create_tmp_variable(scores.dtype)
    helper.append_op(
        "beam_search_decode",
        inputs={"Ids": [ids.name], "Parents": [parents.name],
                "Scores": [scores.name]},
        outputs={"SentenceIds": [sent_ids.name],
                 "SentenceScores": [sent_scores.name]},
        attrs={"end_id": end_id})
    return sent_ids, sent_scores


class DynamicRNN(_RNNBase):
    """Ragged RNN over LoD inputs (reference :453): the batch stays in
    place and each row's memory stops updating past its length, where the
    upstream op sorts by length and shrinks the live batch (identical
    results on the valid rows)."""
    OP_TYPE = "dynamic_recurrent"

    @contextlib.contextmanager
    def block(self):
        with self.step():
            yield

    def static_input(self, x):
        """A non-stepped input read in full every step (reference
        DynamicRNN.static_input): nothing to do — the block closes over it."""
        return x


class IfElse:
    """Per-row conditional (reference control_flow.py IfElse): the reference
    splits rows by a [N, 1] bool condition (split_lod_tensor), runs each
    branch on its subset and merges (merge_lod_tensor). Here both branches
    compute over the full batch and ``()`` merges row-wise with
    where(cond), as the reference package does: identical results, no
    data-dependent shapes.

        ie = layers.IfElse(cond)          # cond: [N, 1] bool
        with ie.true_block():
            ie.output(true_expr)
        with ie.false_block():
            ie.output(false_expr)
        merged, = ie()
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._true_outs = None
        self._false_outs = None
        self._current = None

    def input(self, x):
        """Reference API compatibility: the branch sees the full rows (the
        reference would slice to the branch's subset; select semantics make
        that a no-op here)."""
        return x

    @contextlib.contextmanager
    def true_block(self):
        self._current = []
        yield
        self._true_outs = self._current
        self._current = None

    @contextlib.contextmanager
    def false_block(self):
        self._current = []
        yield
        self._false_outs = self._current
        self._current = None

    def output(self, *outs):
        assert self._current is not None, "output() outside a block"
        self._current.extend(outs)

    def __call__(self):
        if self._true_outs is None or self._false_outs is None:
            raise ValueError("IfElse needs both true_block and false_block")
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError("branches must produce the same output count")
        helper = self.helper
        from .tensor import cast
        cond_f = cast(self.cond, "float32")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            out = helper.create_tmp_variable(t.dtype, shape=t.shape,
                                             lod_level=t.lod_level)
            # where(cond, t, f) = cond*t + (1-cond)*f, broadcasting the
            # [N, 1] condition across feature dims
            helper.append_op("ifelse_merge",
                             inputs={"Cond": [cond_f.name], "TrueVal": [t.name],
                                     "FalseVal": [f.name]},
                             outputs={"Out": [out.name]})
            merged.append(out)
        return merged


def equal(x, y, cond=None):
    """x == y elementwise, bool (reference :562)."""
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_tmp_variable("bool", shape=x.shape,
                                          stop_gradient=True)
    helper.append_op("equal", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]})
    return cond


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Print a variable as the program runs and pass it through (reference
    :471): ``print_phase`` "forward", "backward" (its gradient) or
    "both". Each print copies the tensor to the host."""
    helper = LayerHelper("print")
    out = helper.create_tmp_variable(input.dtype, shape=input.shape,
                                     lod_level=input.lod_level)
    helper.append_op(
        "print", inputs={"In": [input.name]}, outputs={"Out": [out.name]},
        attrs={"first_n": first_n, "message": message or "",
               "summarize": summarize,
               "print_tensor_name": print_tensor_name,
               "print_tensor_type": print_tensor_type,
               "print_tensor_shape": print_tensor_shape,
               "print_tensor_lod": print_tensor_lod,
               "print_phase": print_phase})
    return out


__all__ = ["increment", "less_than", "equal", "create_array", "array_write",
           "array_read", "array_length", "While", "Switch", "StaticRNN",
           "DynamicRNN", "beam_search", "batch_gather", "beam_search_decode",
           "IfElse", "Print"]
