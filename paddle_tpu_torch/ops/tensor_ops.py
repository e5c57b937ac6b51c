"""Creation ops, concat, the variadic sum, top_k and the ops of gradient
clipping, weight decay and learning-rate schedules (counterpart of
paddle_tpu/ops/tensor_ops.py): fill_constant,
fill_constant_batch_size_like, fill_zeros_like, uniform_random,
gaussian_random, cast, scale, assign, sign, clip, clip_by_norm,
squared_l2_norm, increment, reshape, transpose, concat, split, sum, the
comparison and logical ops, top_k and argmax, assign_value, shape,
gather, scatter, one_hot, multiplex and the debug print, with the
reference's grad makers. The LoD-transparent ones keep a LoDArray input's lengths, so the
padded positions of a LoD gradient stay masked downstream. ``sum`` also
adds SparseRows gradients and tensor-array gradients (a ``TensorArrayVal``
read twice); ``fill_zeros_like`` zero-fills either;
``clip``, ``clip_by_norm`` and ``squared_l2_norm`` merge a SparseRows input
first (the clip of a sum is not the sum of the clips).

None of them but ``print`` reads a device value on the host: a schedule,
clip or decay op on the card queues its work and returns. ``print`` is a
debug op that copies its tensor to the host, one sync a call.

Random ops draw from the executor's ``torch.Generator``, seeded once per
scope from ``Program.random_seed``. They do not reproduce the reference's
jax.random draws; cross-package tests copy parameters instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.lod import LoDArray
from ..core.registry import register_op, same_shape, OpSpec, G
from ..core.sparse import SparseRows, add_rows, is_sparse, merge_rows
from ..core.types import torch_dtype
from .common import data_of, like
from .control_flow_ops import TensorArrayVal


@register_op("fill_constant")
def fill_constant(ctx):
    ctx.set_output("Out", torch.full(
        tuple(ctx.attr("shape", [])), ctx.attr("value", 0.0),
        dtype=torch_dtype(ctx.attr("dtype", "float32")), device=ctx.device))


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ctx):
    """``shape`` with dim ``output_dim_idx`` taken from Input's dim
    ``input_dim_idx`` (reference :39)."""
    ref = data_of(ctx.input("Input"))
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        ref.shape[ctx.attr("input_dim_idx", 0)]
    ctx.set_output("Out", torch.full(
        tuple(shape), ctx.attr("value", 0.0),
        dtype=torch_dtype(ctx.attr("dtype", "float32")), device=ctx.device))


@register_op("fill_zeros_like", infer_shape=same_shape("X", "Out"))
def fill_zeros_like(ctx):
    """Zeros shaped like X (reference :52): the grad of a forward output no
    grad op produced; a tensor array's is an array of zeros."""
    x = ctx.input("X")
    if isinstance(x, TensorArrayVal):
        ctx.set_output("Out", TensorArrayVal(torch.zeros_like(x.data),
                                             x.length))
        return
    ctx.set_output("Out", like(x, torch.zeros_like(data_of(x))))


@register_op("uniform_random")
def uniform_random(ctx):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    out = torch.rand(tuple(ctx.attr("shape")), generator=ctx.generator(),
                     dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (out * (hi - lo) + lo).to(
        torch_dtype(ctx.attr("dtype", "float32"))))


@register_op("gaussian_random")
def gaussian_random(ctx):
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    out = torch.randn(tuple(ctx.attr("shape")), generator=ctx.generator(),
                      dtype=torch.float32, device=ctx.device)
    ctx.set_output("Out", (mean + std * out).to(
        torch_dtype(ctx.attr("dtype", "float32"))))


@register_op("reshape", grad=lambda op: [OpSpec(
    "reshape_grad", {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))})])
def reshape(ctx):
    """X's data under ``shape`` (reference :215): 0 copies the input's
    dim, -1 is inferred."""
    x = data_of(ctx.input("X"))
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(ctx.attr("shape"))]
    ctx.set_output("Out", torch.reshape(x, shape))


@register_op("reshape_grad")
def reshape_grad(ctx):
    x = data_of(ctx.input("X"))
    ctx.set_output("X@GRAD", torch.reshape(
        data_of(ctx.input("Out@GRAD")), x.shape))


@register_op("transpose", grad=lambda op: [OpSpec(
    "transpose_grad", {"Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def transpose(ctx):
    """X's dims permuted by ``axis`` (reference :236)."""
    ctx.set_output("Out", data_of(ctx.input("X")).permute(
        *ctx.attr("axis")).contiguous())


@register_op("transpose_grad")
def transpose_grad(ctx):
    inv = [0] * len(ctx.attr("axis"))
    for i, a in enumerate(ctx.attr("axis")):
        inv[a] = i
    ctx.set_output("X@GRAD", data_of(ctx.input("Out@GRAD")).permute(
        *inv).contiguous())


def _concat_axis(ctx, vs):
    """LoD inputs see the reference's flat [rows, feat] axis numbering; the
    padded [b, T, feat] layout shifts positive axes by one (reference
    :249)."""
    axis = ctx.attr("axis", 0)
    if any(isinstance(v, LoDArray) for v in vs) and axis >= 0:
        if axis == 0:
            raise ValueError("concat along the LoD rows axis is not "
                             "supported; use sequence_concat")
        axis += 1
    return axis


@register_op("concat", grad=lambda op: [OpSpec(
    "concat_grad",
    {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def concat(ctx):
    """The inputs joined along ``axis`` (reference :262)."""
    vs = ctx.inputs("X")
    out = torch.cat([data_of(v) for v in vs], dim=_concat_axis(ctx, vs))
    ctx.set_output("Out", like(vs[0], out))


@register_op("concat_grad")
def concat_grad(ctx):
    """Out@GRAD split back into the inputs' widths (reference :272)."""
    vs = ctx.inputs("X")
    axis = _concat_axis(ctx, vs)
    d = data_of(ctx.input("Out@GRAD"))
    parts = torch.split(d, [data_of(v).shape[axis] for v in vs], dim=axis)
    ctx.set_outputs("X@GRAD", [like(v, p.contiguous())
                               for v, p in zip(vs, parts)])


@register_op("split", grad=lambda op: [OpSpec(
    "concat", {"X": G(op.output("Out"))}, {"Out": G(op.input("X"))},
    {"axis": op.attr("axis", 0)})])
def split(ctx):
    """X cut along ``axis`` into ``sections`` widths, or into ``num`` equal
    parts (reference :288); its grad is the concat of the parts' grads."""
    x = data_of(ctx.input("X"))
    axis = ctx.attr("axis", 0)
    if ctx.attr("sections"):
        sizes = list(ctx.attr("sections"))
    else:
        n = ctx.attr("num", 0) or len(ctx.op.output("Out"))
        sizes = [x.shape[axis] // n] * n
    ctx.set_outputs("Out", [p.contiguous()
                            for p in torch.split(x, sizes, dim=axis)])


@register_op("sum", grad=lambda op: [OpSpec(
    "assign", {"X": G(op.output("Out"))}, {"Out": [g]})
    for g in G(op.input("X"))])
def sum_op(ctx):
    """Variadic sum, added left to right (reference :298): the
    backward's rename-and-sum of repeated gradients, a multi-input fc's
    products and the decayed gradient. All-SparseRows inputs concatenate
    their entries in input order (the reference's sum over SelectedRows
    appends rows); a mix of dense and sparse densifies the sparse terms
    (reference :319-330), so a decayed ``is_sparse`` table takes the dense
    update. Its grad is an assign of Out@GRAD to each input's."""
    vs = ctx.inputs("X")
    if isinstance(vs[0], TensorArrayVal):
        # tensor-array gradients (reference :309-318): the float buffers
        # add, the first input's length stays
        out = vs[0].data
        for v in vs[1:]:
            out = out + v.data
        ctx.set_output("Out", TensorArrayVal(out, vs[0].length))
        return
    if any(is_sparse(v) for v in vs):
        if all(is_sparse(v) for v in vs):
            ctx.set_output("Out", SparseRows(
                torch.cat([v.rows for v in vs]),
                torch.cat([v.values for v in vs]), vs[0].nrows))
            return
        vs = [v.to_dense() if is_sparse(v) else v for v in vs]
    out = data_of(vs[0])
    for v in vs[1:]:
        out = out + data_of(v)
    ctx.set_output("Out", like(vs[0], out))


@register_op("scale", infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "scale", {"X": G(op.output("Out"))},
                 {"Out": G(op.input("X"))},
                 {"scale": op.attr("scale", 1.0)})])
def scale(ctx):
    """Out = X·scale + bias (reference :108): the beta-power update that
    Adam appends after its update op, the L2 decay term and every step of
    a schedule. Its grad scales Out@GRAD by ``scale``."""
    x = ctx.input("X")
    ctx.set_output("Out", like(x, data_of(x) * ctx.attr("scale", 1.0)
                             + ctx.attr("bias", 0.0)))


@register_op("cast", grad=lambda op: [OpSpec(
    "cast", {"X": G(op.output("Out"))}, {"Out": G(op.input("X"))},
    {"dtype": op.attr("in_dtype", "float32"), "in_dtype": op.attr("dtype")})])
def cast(ctx):
    """X in ``dtype`` (reference :100): the schedules' int64 step counter
    to float32. Its grad casts Out@GRAD back to ``in_dtype``."""
    x = ctx.input("X")
    ctx.set_output("Out", like(x, data_of(x).to(torch_dtype(
        ctx.attr("dtype")))))


@register_op("assign", infer_shape=same_shape("X", "Out"),
             grad=lambda op: [OpSpec(
                 "assign", {"X": G(op.output("Out"))},
                 {"Out": G(op.input("X"))})])
def assign(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_op("sign", infer_shape=same_shape("X", "Out"))
def sign(ctx):
    """The L1 decay's sign(param) (reference :124); no grad."""
    x = ctx.input("X")
    ctx.set_output("Out", like(x, torch.sign(data_of(x))))


def _clip_grad_maker(op):
    return [OpSpec("clip_grad",
                   {"Out@GRAD": G(op.output("Out")), "X": op.input("X")},
                   {"X@GRAD": G(op.input("X"))}, dict(op.attrs))]


@register_op("clip", infer_shape=same_shape("X", "Out"),
             grad=_clip_grad_maker)
def clip(ctx):
    """X clamped to [min, max] (reference :130). A SparseRows X is merged
    first and comes back merged."""
    x = ctx.input("X")
    lo, hi = ctx.attr("min"), ctx.attr("max")
    if is_sparse(x):
        m = merge_rows(x)
        ctx.set_output("Out", SparseRows(m.rows, torch.clamp(m.values, lo, hi),
                                         m.nrows, merged=True))
        return
    ctx.set_output("Out", like(x, torch.clamp(data_of(x), lo, hi)))


@register_op("clip_grad")
def clip_grad(ctx):
    """Out@GRAD where min <= X <= max, else 0 (reference :147)."""
    x = data_of(ctx.input("X"))
    d = ctx.input("Out@GRAD")
    mask = (x >= ctx.attr("min")) & (x <= ctx.attr("max"))
    ctx.set_output("X@GRAD", like(d, data_of(d) * mask))


def _norm_scale(x, max_norm):
    """max_norm / ‖x‖₂ where ‖x‖₂ > max_norm, else 1, as a device scalar
    (reference :165)."""
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm,
                       max_norm / torch.clamp_min(norm, 1e-12),
                       torch.ones_like(norm))


@register_op("clip_by_norm", infer_shape=same_shape("X", "Out"))
def clip_by_norm(ctx):
    """X scaled down to an L2 norm of ``max_norm`` where it is longer
    (reference :155). A SparseRows X is merged first and clipped by the
    merged value block's norm, the dense gradient's."""
    xv = ctx.input("X")
    max_norm = ctx.attr("max_norm")
    if is_sparse(xv):
        m = merge_rows(xv)
        ctx.set_output("Out", SparseRows(
            m.rows, m.values * _norm_scale(m.values, max_norm), m.nrows,
            merged=True))
        return
    x = data_of(xv)
    ctx.set_output("Out", like(xv, x * _norm_scale(x, max_norm)))


@register_op("squared_l2_norm", grad=lambda op: [OpSpec(
    "squared_l2_norm_grad",
    {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))})])
def squared_l2_norm(ctx):
    """Σ X², shape [1] (reference :176). A SparseRows X is merged first:
    duplicate rows are summed before squaring, and the sentinel segments
    hold the zeroed padding gradients."""
    xv = ctx.input("X")
    x = merge_rows(xv).values if is_sparse(xv) else data_of(xv)
    ctx.set_output("Out", torch.sum(torch.square(x)).reshape((1,)))


@register_op("squared_l2_norm_grad")
def squared_l2_norm_grad(ctx):
    x = data_of(ctx.input("X"))
    d = data_of(ctx.input("Out@GRAD")).reshape(())
    ctx.set_output("X@GRAD", 2.0 * d * x)


@register_op("increment")
def increment(ctx):
    """X + step in X's dtype (reference :201): the schedules' int64 step
    counter."""
    x = data_of(ctx.input("X"))
    ctx.set_output("Out", x + torch.tensor(ctx.attr("step", 1.0)).to(
        x.dtype))


@register_op("top_k")
def top_k(ctx):
    """The k largest entries of the last axis and their int64 indices
    (reference :395), in descending order, the lower index first among
    equal values (as jax.lax.top_k). Float32 is ordered as XLA's sort
    orders it, by the IEEE total order (-0.0 below +0.0). Out and Indices
    keep X's LoD: the ctc_greedy_decoder path takes the arg-max of ragged
    logits."""
    xin = ctx.input("X")
    x = data_of(xin)
    key = x
    if x.dtype == torch.float32:
        bits = x.view(torch.int32)
        key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True,
                     stable=True).indices[..., :ctx.attr("k", 1)]
    ctx.set_output("Out", like(xin, torch.gather(x, -1, idx)))
    ctx.set_output("Indices", like(xin, idx))


def _cmp(name, fn):
    """A comparison or logical op, Out = fn(X, Y), no grad (reference
    :370)."""
    @register_op(name)
    def op(ctx):
        ctx.set_output("Out", fn(data_of(ctx.input("X")),
                                 data_of(ctx.input("Y"))))


_cmp("less_than", lambda x, y: x < y)
_cmp("less_equal", lambda x, y: x <= y)
_cmp("greater_than", lambda x, y: x > y)
_cmp("greater_equal", lambda x, y: x >= y)
_cmp("equal", lambda x, y: x == y)
_cmp("not_equal", lambda x, y: x != y)
_cmp("logical_and", lambda x, y: x & y)
_cmp("logical_or", lambda x, y: x | y)
_cmp("logical_xor", lambda x, y: x ^ y)


@register_op("logical_not")
def logical_not(ctx):
    ctx.set_output("Out", ~data_of(ctx.input("X")))


@register_op("argmax")
def argmax(ctx):
    """The int64 index of the largest entry along ``axis`` (reference
    :416)."""
    x = data_of(ctx.input("X"))
    ctx.set_output("Out", torch.argmax(x, dim=ctx.attr("axis", -1)))


@register_op("assign_value")
def assign_value(ctx):
    """The ``values`` attribute as a tensor of ``shape`` (reference :81)
    in the attribute ``dtype`` where given, else float32 for floats and
    int32 for integers, as the reference gives them."""
    values = np.asarray(ctx.attr("values"))
    dtype = ctx.attr("dtype")
    if dtype is not None:
        t = torch_dtype(dtype)
    else:
        t = torch.float32 if values.dtype.kind == "f" else (
            torch.bool if values.dtype.kind == "b" else torch.int32)
    ctx.set_output("Out", torch.tensor(
        values.reshape(tuple(ctx.attr("shape", values.shape))), dtype=t,
        device=ctx.device))


@register_op("shape")
def shape_op(ctx):
    """Input's dims as an int64 vector (reference :207): the padded dims of
    a LoDArray."""
    x = data_of(ctx.input("Input"))
    ctx.set_output("Out", torch.tensor(list(x.shape), dtype=torch.int64,
                                       device=ctx.device))


@register_op("gather", grad=lambda op: [OpSpec(
    "gather_grad",
    {"X": op.input("X"), "Index": op.input("Index"),
     "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))})])
def gather(ctx):
    """Rows of X at Index (reference :340): Out's shape is Index's shape
    followed by X's row shape."""
    x = data_of(ctx.input("X"))
    ctx.set_output("Out", x[data_of(ctx.input("Index")).long()])


@register_op("gather_grad")
def gather_grad(ctx):
    """Out@GRAD's rows added into zeros at their indices, duplicates summed
    in order (``core/sparse.py::add_rows``)."""
    x = data_of(ctx.input("X"))
    idx = data_of(ctx.input("Index")).long().reshape(-1)
    d = data_of(ctx.input("Out@GRAD")).reshape((-1,) + tuple(x.shape[1:]))
    ctx.set_output("X@GRAD", add_rows(torch.zeros_like(x), idx,
                                      d.to(x.dtype)))


@register_op("scatter")
def scatter(ctx):
    """X with its rows at Ids overwritten by Updates (reference :359); no
    grad, as the reference's."""
    out = data_of(ctx.input("X")).clone()
    out[data_of(ctx.input("Ids")).long()] = data_of(ctx.input("Updates")) \
        .to(out.dtype)
    ctx.set_output("Out", out)


@register_op("one_hot")
def one_hot(ctx):
    """Int ids (a trailing dim of 1 dropped) as float32 one-hot rows of
    ``depth`` (reference :407)."""
    x = data_of(ctx.input("X"))
    flat = x.reshape(x.shape[:-1]) if x.ndim and x.shape[-1] == 1 else x
    ctx.set_output("Out", F.one_hot(flat.long(), int(ctx.attr("depth")))
                   .to(torch.float32))


@register_op("multiplex")
def multiplex(ctx):
    """Row i of Out is row i of the candidate X[Ids[i]] (reference
    :424)."""
    ids = data_of(ctx.input("Ids")).reshape(-1).long()
    xs = torch.stack([data_of(v) for v in ctx.inputs("X")])
    ctx.set_output("Out", xs[ids, torch.arange(ids.shape[0],
                                                device=ids.device)])


_PRINT_COUNTS: dict = {}


def _print_grad_maker(op):
    """The backward phases print the gradient (a print op on Out@GRAD);
    print_phase="forward" passes it through with an assign (reference
    :439)."""
    if op.attr("print_phase", "both") in ("backward", "both"):
        return [OpSpec("print", {"In": G(op.output("Out"))},
                       {"Out": G(op.input("In"))},
                       {**dict(op.attrs),
                        "message": (op.attr("message", "") or "") + " @GRAD",
                        "print_phase": "forward",
                        "is_backward_print": True})]
    return [OpSpec("assign", {"X": G(op.output("Out"))},
                   {"Out": G(op.input("In"))})]


@register_op("print", infer_shape=same_shape("In", "Out"),
             grad=_print_grad_maker)
def print_op(ctx):
    """Debug print (print_op.cc): the message, the tensor's name, dtype and
    shape and its first ``summarize`` values on one line for the first
    ``first_n`` runs of the op (every run when negative), then the value
    passed through unchanged. Printing copies the tensor to the host."""
    xv = ctx.input("In")
    x = data_of(xv)
    if ctx.attr("print_phase", "both") in ("forward", "both") \
            or ctx.attr("is_backward_print", False):
        key = id(ctx.op)
        count = _PRINT_COUNTS.get(key, 0)
        first_n = int(ctx.attr("first_n", -1))
        if first_n < 0 or count < first_n:
            _PRINT_COUNTS[key] = count + 1
            message = ctx.attr("message", "") or ""
            parts = [message] if message else []
            if ctx.attr("print_tensor_name", True):
                parts.append(f"name={ctx.op.input('In')[0]}")
            if ctx.attr("print_tensor_type", True):
                parts.append(f"dtype={str(x.dtype).replace('torch.', '')}")
            if ctx.attr("print_tensor_shape", True):
                parts.append(f"shape={tuple(x.shape)}")
            flat = x.detach().reshape(-1)
            summarize = int(ctx.attr("summarize", 20))
            k = flat.numel() if summarize < 0 else min(summarize,
                                                       flat.numel())
            parts.append(f"data={flat[:k].cpu().tolist()}")
            print("[print op] " + "  ".join(parts), flush=True)
    ctx.set_output("Out", like(xv, x))
