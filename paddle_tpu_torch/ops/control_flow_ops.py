"""Control-flow ops (counterpart of paddle_tpu/ops/control_flow_ops.py):
tensor arrays, ``while``, ``conditional_block``, ``recurrent`` and
``dynamic_recurrent`` (StaticRNN / DynamicRNN), ``batch_gather``, both
forms of ``beam_search``, ``beam_search_decode`` and ``ifelse_merge``, with
the reference's grad makers.

The executor runs eagerly, so a loop is a Python loop over the sub-block:

* A tensor array is a ``TensorArrayVal``: a pre-allocated [cap, ...]
  tensor on the executor's device plus a 0-d int32 length there. The first
  write fixes the element shape. The index of a write or read stays a
  device tensor (``index_copy`` / ``index_select``, clamped into the
  buffer as the reference's dynamic slices clamp), so neither syncs the
  host.
* ``while`` runs its block while the condition holds, at most
  ``max_iters`` times when the attr is set: the reference's masked scan of
  ``max_iters`` steps holds the state once the condition turns false, so
  stopping there gives the same values. Reading the condition is one host
  sync per iteration. The carry is the condition plus every name the block
  writes that already exists in the enclosing env; anything else the block
  writes is a per-iteration temporary.
* ``recurrent`` / ``dynamic_recurrent`` step the block over the time axis;
  the dynamic form masks each row's memory and outputs past its length
  over the padded LoD batch, as the reference does (no rank-table
  reordering).
* ``while_grad`` and ``recurrent_grad`` replay the same loop under autograd
  (the executor's op loop runs under ``torch.no_grad()``) and take the
  vector-Jacobian product with respect to the free float inputs the block
  reads and, for ``while``, the pre-loop carried state. Integer leaves
  (counters, id arrays, lengths) take no gradient; their grads are zeros.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of


class TensorArrayVal:
    """Pre-allocated tensor array (reference :45): data [cap, ...], length
    a 0-d int32 tensor."""

    __slots__ = ("data", "length")

    def __init__(self, data, length):
        self.data = data
        self.length = length

    @property
    def cap(self):
        return self.data.shape[0]

    def __repr__(self):
        return (f"TensorArrayVal(cap={tuple(self.data.shape)}, "
                f"length={self.length})")


class EmptyTensorArray:
    """Placeholder until the first write fixes the element shape
    (reference :70)."""

    def __init__(self, cap):
        self.cap = cap


def _index(v, cap):
    """A scalar index as a [1] int64 device tensor, clamped into [0,
    cap)."""
    return data_of(v).reshape(1).long().clamp(0, cap - 1)


def _write_to_array_grad_maker(op):
    """The element's grad is slot i of the array's grad; the array's grad
    loses slot i, overwriting the later grad of the same name (the array
    name is rebound in place, as ``while``'s carried state is). This is
    what lets a value staged through a tensor array into a loop train
    (reference :81)."""
    return [OpSpec(
        "write_to_array_grad",
        {"I": op.input("I"), "Out@GRAD": G(op.output("Out"))},
        {"X@GRAD": G(op.input("X")),
         "Array@GRAD": G(op.input("Array")) if op.input("Array") else []},
        dict(op.attrs), overwrite_slots=frozenset({"Array@GRAD"}))]


@register_op("write_to_array", grad=_write_to_array_grad_maker)
def write_to_array(ctx):
    """Array[I] = X (reference :96): the array var is both input Array and
    output Out; the first write allocates the [cap, ...] buffer from X's
    shape and dtype, later writes cast to it."""
    x = data_of(ctx.input("X"))
    arr = ctx.input("Array") if ctx.has_input("Array") else None
    if arr is None or isinstance(arr, EmptyTensorArray):
        cap = arr.cap if arr is not None else ctx.attr("cap", 64)
        arr = TensorArrayVal(
            torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device),
            torch.zeros((), dtype=torch.int32, device=x.device))
    i = _index(ctx.input("I"), arr.cap)
    data = arr.data.index_copy(0, i, x.to(arr.data.dtype)[None])
    length = torch.maximum(arr.length,
                           data_of(ctx.input("I")).reshape(()).to(
                               torch.int32) + 1)
    ctx.set_output("Out", TensorArrayVal(data, length))


@register_op("write_to_array_grad")
def write_to_array_grad(ctx):
    g = ctx.input("Out@GRAD")
    i = _index(ctx.input("I"), g.cap)
    ctx.set_output("X@GRAD", g.data.index_select(0, i)[0])
    if ctx.op.output("Array@GRAD"):
        ctx.set_output("Array@GRAD", TensorArrayVal(
            g.data.index_fill(0, i, 0), g.length))


@register_op("read_from_array", grad=lambda op: [OpSpec(
    "read_from_array_grad",
    {"X": op.input("X"), "I": op.input("I"),
     "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))})])
def read_from_array(ctx):
    """Array[I] (reference :134); past the written length it reads what
    the buffer holds there (zeros if never written), past the capacity the
    last slot."""
    arr = ctx.input("X")
    ctx.set_output("Out", arr.data.index_select(
        0, _index(ctx.input("I"), arr.cap))[0])


@register_op("read_from_array_grad")
def read_from_array_grad(ctx):
    arr = ctx.input("X")
    dy = data_of(ctx.input("Out@GRAD")).to(arr.data.dtype)
    ctx.set_output("X@GRAD", TensorArrayVal(
        torch.zeros_like(arr.data).index_copy(
            0, _index(ctx.input("I"), arr.cap), dy[None]), arr.length))


@register_op("array_length")
def array_length(ctx):
    """[1] int64 length of a tensor array (reference :152)."""
    ctx.set_output("Out", ctx.input("X").length.reshape(1).to(torch.int64))


@register_op("max_sequence_len")
def max_sequence_len(ctx):
    """[1] int64 longest length of a LoD input (reference :160)."""
    x = ctx.input("RankTable")
    lens = x.lens if isinstance(x, LoDArray) else data_of(x)
    ctx.set_output("Out", lens.max().reshape(1).to(torch.int64))


# ---------------------------------------------------------------------------
# values with one float leaf: tensors, LoDArrays, tensor arrays
# ---------------------------------------------------------------------------

def _leaf(v):
    """The tensor an op value computes on: a LoDArray's data, a tensor
    array's buffer, a tensor itself; None for anything else."""
    if isinstance(v, (LoDArray, TensorArrayVal)):
        return v.data
    return v if isinstance(v, torch.Tensor) else None


def _float_leaf(v):
    t = _leaf(v)
    return t if t is not None and t.is_floating_point() else None


def _rewrap(v, t):
    """``v`` with its leaf replaced by ``t`` (lengths kept)."""
    if isinstance(v, LoDArray):
        return v.with_data(t)
    if isinstance(v, TensorArrayVal):
        return TensorArrayVal(t, v.length)
    return t


def _zeros_like(v):
    """A zero gradient shaped like ``v``; a tensor array's has length 0,
    as the reference's float0 length does."""
    if isinstance(v, TensorArrayVal):
        return TensorArrayVal(torch.zeros_like(v.data),
                              torch.zeros_like(v.length))
    t = _leaf(v)
    if t is None:
        return torch.zeros(())
    return _rewrap(v, torch.zeros_like(t))


def _grad_of(v, g):
    """A gradient tensor ``g`` for value ``v``, wrapped as ``v`` is."""
    if g is None:
        return _zeros_like(v)
    if isinstance(v, TensorArrayVal):
        return TensorArrayVal(g, torch.zeros_like(v.length))
    return _rewrap(v, g)


def _replay_vjp(fn, primals, outputs_ct):
    """Autograd through ``fn`` (a replay of a loop): ``primals`` maps names
    to values whose float leaves become leaves of the tape; ``fn(values)``
    returns {name: value}; ``outputs_ct(name, value)`` gives the cotangent
    tensor of an output's float leaf, or None. Returns {name: leaf grad
    or None}."""
    with torch.enable_grad():
        leaves, vals = {}, {}
        for n, v in primals.items():
            t = _float_leaf(v)
            if t is None:
                vals[n] = v
                continue
            leaves[n] = t.detach().requires_grad_(True)
            vals[n] = _rewrap(v, leaves[n])
        outs = fn(vals)
        ys, cts = [], []
        for n, v in outs.items():
            t = _float_leaf(v)
            if t is None or not t.requires_grad:
                continue
            ct = outputs_ct(n, t)
            if ct is not None:
                ys.append(t)
                cts.append(ct.to(t.dtype).reshape(t.shape))
        names = list(leaves)
        if not ys or not names:
            return {n: None for n in primals}
        grads = torch.autograd.grad(ys, [leaves[n] for n in names], cts,
                                    allow_unused=True)
    out = {n: None for n in primals}
    out.update(zip(names, grads))
    return out


def _emit_diff_grads(ctx, env, all_diff, grads):
    """Write the grads to the declared DiffGrads names in diff_vars order
    (the backward may have renamed one for rename-and-sum); missing or
    non-float ones are zeros (reference :608)."""
    ctx.set_outputs("DiffGrads", [_grad_of(env[n], grads.get(n))
                                  for n in all_diff])


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------

def _block_written(block):
    """Names the block writes, nested sub-blocks included: a nested loop
    writing an outer var must still be in the enclosing loop's carry."""
    from ..core.block_walk import written_names
    return written_names(block.program, block.idx)


def _const_producer_value(name, blocks):
    """The fill_constant value that produced ``name`` in any of ``blocks``
    (None when it is not a build-time constant)."""
    for b in blocks:
        for o in b.ops:
            if name in o.output("Out") and o.type == "fill_constant":
                return float(o.attrs.get("value", 0.0))
    return None


def _derive_while_bound(op):
    """A static trip-count bound for a while without ``max_iters``
    (reference :191), from the counter loop the decoders build::

        i = fill_constant(C0);  limit = fill_constant(V)
        while less_than(i, limit):  ...;  i = increment(i, S)

    ceil((V - C0) / S), +1 for less_equal. None when the pattern does not
    match (a limit fed at run time)."""
    block = op.block
    sub = block.program.blocks[op.attrs["sub_block"]]
    cond_name = op.input("Condition")[0]
    cmp_op = None
    for o in list(sub.ops) + list(block.ops):
        if cond_name in o.output("Out") and o.type in ("less_than",
                                                       "less_equal"):
            cmp_op = o
    if cmp_op is None:
        return None
    counter, limit = cmp_op.input("X")[0], cmp_op.input("Y")[0]
    v = _const_producer_value(limit, [block])
    c0 = _const_producer_value(counter, [block])
    if v is None or c0 is None:
        return None
    step = None
    for o in sub.ops:
        if o.type == "increment" and counter in o.output("Out"):
            step = float(o.attrs.get("step", 1.0))
    if not step or step <= 0:
        return None
    bound = int(math.ceil((v - c0) / step))
    if cmp_op.type == "less_equal":
        bound += 1
    return max(bound, 1)


def _while_grad_maker(op):
    """while_grad consumes the pre-loop snapshots and the post-loop output
    grads and produces the grads of the free float reads of the body and
    of the pre-loop carried state; the latter OVERWRITE the carried names'
    post-loop grads (reference :238). Needs a bound: ``max_iters``, or one
    derived from the counter pattern."""
    attrs = dict(op.attrs)
    if attrs.get("max_iters") is None:
        attrs["max_iters"] = _derive_while_bound(op)
    if attrs.get("max_iters") is None:
        raise RuntimeError(
            "while op lies on a gradient path, has no max_iters bound, and "
            "no static bound could be derived from its condition (expected "
            "the counter pattern: fill_constant init, less_than/less_equal "
            "against a fill_constant limit, increment in the body); build "
            "it as fluid.layers.While(cond, max_iters=N) to train through "
            "it")
    return [OpSpec(
        "while_grad",
        {"Condition": op.input("Condition"), "Carried": op.input("Carried"),
         "FreeVars": op.input("FreeVars"), "PreLoop": op.output("PreLoop"),
         "OutGrads": G(op.output("Out"))},
        {"DiffGrads": G(op.attrs.get("diff_vars", [])),
         "CarriedGrads": G(op.attrs.get("carried", []))},
        attrs, overwrite_slots=frozenset({"CarriedGrads"}))]


def _cond_true(v):
    """The loop condition on the host: one sync."""
    return bool(data_of(v).reshape(()).item())


def _while_loop(sub, env_base, pre, carried, cond_name, max_iters, device):
    """Run ``sub`` over copies of ``env_base`` with the carry ``pre`` while
    the condition holds and fewer than ``max_iters`` (None: no bound)
    iterations ran; returns the final carry. Both the forward and
    while_grad run it, so the gradient differentiates the function that
    ran."""
    from ..core.executor import _run_ops
    carry = dict(pre)
    it = 0
    while (max_iters is None or it < max_iters) \
            and _cond_true(carry[cond_name]):
        local = dict(env_base)
        local.update(carry)
        _run_ops(sub, local, device)
        carry = {n: local[n] for n in carried}
        it += 1
    return carry


@register_op("while", is_control_flow=True, grad=_while_grad_maker)
def while_op(ctx):
    """Loop over the sub-block (reference :295); the pre-loop values of the
    carried names are kept under the op's PreLoop outputs for
    while_grad."""
    sub = ctx.sub_block("sub_block")
    cond_name = ctx.op.input("Condition")[0]
    env = ctx.env
    carry_names = [n for n in _block_written(sub) if n in env]
    if cond_name not in carry_names:
        carry_names.append(cond_name)
    init = {n: env[n] for n in carry_names}
    for n, pname in zip(ctx.attr("carried", []), ctx.op.output("PreLoop")):
        if n in init:
            env[pname] = init[n]
    max_iters = ctx.attr("max_iters", None)
    env.update(_while_loop(sub, env, init, carry_names, cond_name,
                           None if max_iters is None else int(max_iters),
                           ctx.device))


@register_op("while_grad", is_control_flow=True)
def while_grad(ctx):
    """The loop replayed from the PreLoop snapshots under autograd, its
    vjp with respect to the free float reads and the pre-loop carried
    float state (reference :342). CarriedGrads overwrite the carried names'
    grads (see _while_grad_maker)."""
    env = ctx.env
    sub = ctx.sub_block("sub_block")
    cond_name = ctx.op.input("Condition")[0]
    carried_attr = list(ctx.attr("carried", []))
    all_diff = list(ctx.attr("diff_vars", []))
    preloop = dict(zip(carried_attr, ctx.op.input("PreLoop")))
    pre = {n: env[preloop[n]] for n in carried_attr if preloop[n] in env}
    carried = [n for n in carried_attr if n in pre]
    max_iters = int(ctx.attr("max_iters"))
    primals = {("w", n): env[n] for n in all_diff}
    primals.update({("c", n): v for n, v in pre.items()})

    def fn(vals):
        base = dict(env)
        base.update({n: v for (k, n), v in vals.items() if k == "w"})
        start = {n: v for (k, n), v in vals.items() if k == "c"}
        final = _while_loop(sub, base, start, carried, cond_name,
                            max_iters, ctx.device)
        return {("c", n): v for n, v in final.items()}

    def ct(key, _t):
        g = env.get(G(key[1]))
        return None if g is None else _float_leaf(g)

    grads = _replay_vjp(fn, primals, ct)
    _emit_diff_grads(ctx, env, all_diff,
                     {n: grads[("w", n)] for n in all_diff})
    ctx.set_outputs("CarriedGrads", [
        _grad_of(pre[n], grads[("c", n)]) if n in pre else torch.zeros(())
        for n in carried_attr])


@register_op("conditional_block", is_control_flow=True)
def conditional_block(ctx):
    """Run the block when the scalar Cond holds (one host sync), else keep
    the previous bindings of the names it writes, zeros where a name is
    unbound (reference :420: both branches are traced there, only the
    taken one runs)."""
    from ..core.executor import _run_ops
    sub = ctx.sub_block("sub_block")
    env = ctx.env
    written = _block_written(sub)
    taken = _cond_true(ctx.inputs("Cond")[0])
    if not taken and all(n in env for n in written):
        return
    local = dict(env)
    _run_ops(sub, local, ctx.device)
    for n in written:
        if taken:
            env[n] = local[n]
        elif n not in env:
            env[n] = _zeros_like(local[n])


# ---------------------------------------------------------------------------
# recurrent (StaticRNN) and dynamic_recurrent (DynamicRNN)
# ---------------------------------------------------------------------------

def _run_recurrent(sub, attr, env, lens, device):
    """Step the block over the time axis (reference :492). attrs:
    step_inputs [outer names], step_vars [block-local per-step names],
    memories [(mem_name, new_name)], mem_inits {mem: init name}, outputs
    [block names]. ``lens`` is None for StaticRNN (every row runs the full
    length) or the [b] lengths that mask DynamicRNN's rows. Returns
    ({out: stacked [b, T, ...]}, {mem: final [b, ...]}) and leaves ``env``
    as it was."""
    from ..core.executor import _run_ops
    memories = [tuple(m) for m in attr("memories", [])]
    mem_inits = attr("mem_inits", {})
    out_names = attr("outputs", [])
    xs, T = {}, None
    for outer, inner in zip(attr("step_inputs", []), attr("step_vars", [])):
        xs[inner] = data_of(env[outer])
        T = xs[inner].shape[1]
    carry = {mem: data_of(env[mem_inits[mem]]) for mem, _ in memories}
    stacked = {o: [] for o in out_names}

    def alive_like(t, v):
        return (t < lens).reshape((-1,) + (1,) * (v.ndim - 1)).to(v.dtype)

    for t in range(T):
        local = dict(env)
        local.update(carry)
        local.update({n: x[:, t] for n, x in xs.items()})
        _run_ops(sub, local, device)
        new = {}
        for mem, name in memories:
            v = data_of(local[name])
            if lens is not None:
                a = alive_like(t, v)
                v = a * v + (1 - a) * carry[mem]
            new[mem] = v
        carry = new
        for o in out_names:
            v = data_of(local[o])
            stacked[o].append(v if lens is None else v * alive_like(t, v))
    return ({o: torch.stack(v, 1) for o, v in stacked.items()},
            {mem: carry[mem] for mem, _ in memories})


def _recurrent_fwd(ctx, lens):
    stacked, finals = _run_recurrent(ctx.sub_block("sub_block"), ctx.attr,
                                     ctx.env, lens, ctx.device)
    for o, v in stacked.items():
        ctx.env[o + "@STACKED"] = LoDArray(v, lens) if lens is not None \
            else v
    for m, v in finals.items():
        ctx.env[m + "@FINAL"] = v


def _recurrent_grad_maker(op):
    """The grad op takes the forward's inputs and output grads and gives
    the grads of every differentiable outer var (reference :559)."""
    return [OpSpec(
        op.type + "_grad",
        {"Inputs": op.input("Inputs"), "MemInits": op.input("MemInits"),
         "FreeVars": op.input("FreeVars"),
         "StackedGrad": G(op.output("Stacked")),
         "FinalGrad": G(op.output("FinalMems"))},
        {"DiffGrads": G(op.attrs.get("diff_vars", []))},
        dict(op.attrs))]


def _dyn_lens(ctx):
    first = ctx.env[ctx.attr("step_inputs")[0]]
    if not isinstance(first, LoDArray):
        raise TypeError("dynamic_recurrent expects LoD step inputs")
    return first.lens


@register_op("recurrent", is_control_flow=True, grad=_recurrent_grad_maker)
def recurrent(ctx):
    _recurrent_fwd(ctx, lens=None)


@register_op("dynamic_recurrent", is_control_flow=True,
             grad=_recurrent_grad_maker)
def dynamic_recurrent(ctx):
    _recurrent_fwd(ctx, lens=_dyn_lens(ctx))


def _recurrent_grad(ctx, lens):
    """The vjp of the stepped block with respect to every differentiable
    outer var (step inputs, memory inits and the weights the block reads),
    by autograd through a replay (reference :625)."""
    env = ctx.env
    sub = ctx.sub_block("sub_block")
    all_diff = list(ctx.attr("diff_vars", []))

    def fn(vals):
        local = dict(env)
        local.update(vals)
        stacked, finals = _run_recurrent(sub, ctx.attr, local, lens,
                                         ctx.device)
        out = {o + "@STACKED": v for o, v in stacked.items()}
        out.update({m + "@FINAL": v for m, v in finals.items()})
        return out

    def ct(name, _t):
        g = env.get(G(name))
        return None if g is None else data_of(g)

    grads = _replay_vjp(fn, {n: env[n] for n in all_diff}, ct)
    _emit_diff_grads(ctx, env, all_diff, grads)


@register_op("recurrent_grad", is_control_flow=True)
def recurrent_grad(ctx):
    _recurrent_grad(ctx, lens=None)


@register_op("dynamic_recurrent_grad", is_control_flow=True)
def dynamic_recurrent_grad(ctx):
    _recurrent_grad(ctx, lens=_dyn_lens(ctx))


@register_op("batch_gather")
def batch_gather(ctx):
    """Out[i, j] = X[i, Index[i, j]] over the second axis (reference
    :680): the beam state reordered by parent_idx."""
    x = data_of(ctx.input("X"))
    idx = data_of(ctx.input("Index")).long()
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    ctx.set_output("Out", x[rows, idx])


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _host(t):
    return np.asarray(t.cpu() if torch.is_tensor(t) else t)


def _beam_search_lod(ctx):
    """The reference's variable-width LoD beam step (:695,
    beam_search_op.cc): ids/scores are 2-level LoD, level 0 grouping
    prefixes per source and each prefix row holding its candidates;
    pre_ids is [n_prefix]. Per source, the top beam_size candidates across
    its prefixes (descending score, ties in prefix then candidate order),
    regrouped by prefix; a finished prefix (pre_id == end_id) keeps none;
    each group sorted by ascending id. Output widths shrink as hypotheses
    finish. A host op: its output widths depend on the data."""
    ids_v, scores_v = ctx.input("ids"), ctx.input("scores")
    pre_ids = _host(data_of(ctx.input("pre_ids"))).reshape(-1)
    beam = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    cand_ids = _host(ids_v.data)
    cand_scores = _host(scores_v.data)
    lens = _host(ids_v.lens).reshape(-1)
    outer = _host(ids_v.outer_levels[-1]).reshape(-1)
    n_prefix = cand_ids.shape[0]
    cand_ids = cand_ids.reshape(n_prefix, -1)
    cand_scores = cand_scores.reshape(n_prefix, -1)

    per_prefix = [[] for _ in range(n_prefix)]
    start = 0
    for width in outer:
        items = [(p, int(cand_ids[p, c]), float(cand_scores[p, c]))
                 for p in range(start, start + int(width))
                 for c in range(int(lens[p]))]
        items.sort(key=lambda it: -it[2])
        for p, i, s in items[:beam]:
            per_prefix[p].append((i, s))
        start += int(width)
    for p in range(n_prefix):
        if pre_ids[p] == end_id:
            per_prefix[p] = []

    widths = np.asarray([len(v) for v in per_prefix], np.int32)
    max_w = max(int(widths.max()) if n_prefix else 0, 1)
    out_ids = np.zeros((n_prefix, max_w, 1), np.int64)
    out_scores = np.zeros((n_prefix, max_w, 1), np.float32)
    for p, items in enumerate(per_prefix):
        items.sort(key=lambda it: it[0])
        for j, (i, s) in enumerate(items):
            out_ids[p, j, 0] = i
            out_scores[p, j, 0] = s
    dev = ids_v.lens.device
    lens_t = torch.from_numpy(widths).to(dev)
    for slot, data in (("selected_ids", out_ids),
                       ("selected_scores", out_scores)):
        ctx.set_output(slot, LoDArray(torch.from_numpy(data).to(dev),
                                      lens_t, ids_v.outer_levels))


@register_op("beam_search")
def beam_search(ctx):
    """One beam step. LoD candidates take the reference's variable-width
    form (``_beam_search_lod``). Dense form (reference :761): pre_ids
    [b, beam] int, pre_scores [b, beam] (accumulated log-probs), ids
    [b, beam, k] candidate tokens, scores [b, beam, k] candidate log-probs.
    A finished beam (pre_id == end_id) continues only with end_id at its
    unchanged score. Outputs selected_ids / selected_scores [b, beam] and
    parent_idx [b, beam] (the source beam of each). Ties keep the lower
    flat index first, as ``jax.lax.top_k`` does: a stable sort on the
    negated scores."""
    if isinstance(ctx.input("ids"), LoDArray):
        _beam_search_lod(ctx)
        return
    pre_ids = data_of(ctx.input("pre_ids")).long()
    pre_scores = data_of(ctx.input("pre_scores"))
    cand_ids = data_of(ctx.input("ids")).long()
    cand_scores = data_of(ctx.input("scores"))
    beam = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))

    b, bm, k = cand_scores.shape
    finished = (pre_ids == end_id)[:, :, None]                # [b, beam, 1]
    total = pre_scores[:, :, None] + cand_scores              # [b, beam, k]
    keep_first = torch.arange(k, device=total.device)[None, None, :] == 0
    total = torch.where(finished,
                        torch.where(keep_first, pre_scores[:, :, None], -1e9),
                        total)
    ids_eff = torch.where(finished, torch.full_like(cand_ids, end_id),
                          cand_ids)
    flat = total.reshape(b, bm * k)
    order = torch.sort(-flat, dim=1, stable=True).indices[:, :beam]
    ctx.set_output("selected_ids",
                   torch.gather(ids_eff.reshape(b, bm * k), 1, order)
                   .to(torch.int32))
    ctx.set_output("selected_scores", torch.gather(flat, 1, order))
    ctx.set_output("parent_idx", (order // k).to(torch.int32))


@register_op("beam_search_decode")
def beam_search_decode(ctx):
    """Backtrack the beams (reference :802): Ids / Parents are tensor
    arrays of [b, beam] a step (Ids[0] the start token), Scores the final
    accumulated scores [b, beam]. SentenceIds is a 2-level LoDArray: level
    0 groups the beam rows of each source (beam 0 the best), level 1 holds
    each row's tokens up to and including its first end_id within the
    written steps; SentenceScores is [b * beam]. The walk back is T steps
    of gathers on the device, no host sync."""
    ids_arr, parents_arr = ctx.input("Ids"), ctx.input("Parents")
    scores = data_of(ctx.input("Scores"))
    end_id = int(ctx.attr("end_id"))
    ids, parents = ids_arr.data, parents_arr.data.long()  # [T, b, beam]
    T, b, beam = ids.shape[0], ids.shape[1], ids.shape[2]
    dev = ids.device
    carry = torch.arange(beam, device=dev)[None, :].expand(b, beam)
    oks = torch.arange(T, device=dev) < ids_arr.length      # written steps
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, carry)
        carry = torch.where(oks[t], torch.gather(parents[t], 1, carry),
                            carry)
    seqs = torch.stack(toks, 2).reshape(b * beam, T)
    written = oks[None, :].expand(b * beam, T)
    is_end = (seqs == end_id) & written
    first_end = torch.argmax(is_end.to(torch.int32), dim=1)
    total = written.sum(dim=1)
    lens = torch.where(is_end.any(dim=1), first_end + 1, total) \
        .to(torch.int32)
    outer = torch.full((b,), beam, dtype=torch.int32, device=dev)
    ctx.set_output("SentenceIds", LoDArray(seqs[..., None], lens, outer))
    ctx.set_output("SentenceScores", scores.reshape(b * beam))


@register_op("ifelse_merge", grad=lambda op: [OpSpec(
    "ifelse_merge_grad",
    {"Cond": op.input("Cond"), "Out@GRAD": G(op.output("Out"))},
    {"TrueVal@GRAD": G(op.input("TrueVal")),
     "FalseVal@GRAD": G(op.input("FalseVal"))})])
def ifelse_merge(ctx):
    """Row-wise select merging IfElse's branches (reference :860)."""
    cond = data_of(ctx.input("Cond"))
    t = data_of(ctx.input("TrueVal"))
    f = data_of(ctx.input("FalseVal"))
    c = cond.reshape((cond.shape[0],) + (1,) * (t.ndim - 1)) > 0.5
    ctx.set_output("Out", torch.where(c, t, f))


@register_op("ifelse_merge_grad")
def ifelse_merge_grad(ctx):
    cond = data_of(ctx.input("Cond"))
    d = data_of(ctx.input("Out@GRAD"))
    c = cond.reshape((cond.shape[0],) + (1,) * (d.ndim - 1)) > 0.5
    zero = torch.zeros_like(d)
    ctx.set_output("TrueVal@GRAD", torch.where(c, d, zero))
    ctx.set_output("FalseVal@GRAD", torch.where(c, zero, d))
