"""Sequence (LoD) ops over the padded LoDArray (counterpart of
paddle_tpu/ops/sequence_ops.py): ``sequence_pool`` of every pooltype, with
stride windows and pooling to a sequence over nested LoD,
``sequence_softmax``, ``sequence_expand`` (with ``ref_level``),
``sequence_concat``, ``sequence_reshape``, ``sequence_slice``,
``sequence_erase``, ``lod_reset``, ``sequence_conv`` and ``row_conv``,
with their grads.

Every op is a masked dense computation over [batch, max_len, *feat] data
and [batch] lengths. A grad is the autograd vjp of the same function
(``ops/common.py::vjp``) where the reference takes ``jax.vjp``, else the
reference's closed form.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G, same_shape
from .common import data_of, vjp


def _seq(v):
    if not isinstance(v, LoDArray):
        raise TypeError(f"sequence op expects a LoDArray input, got "
                        f"{type(v).__name__}")
    return v


def _rows_to_level0(y):
    """[batch] int64: the outermost group of each data row, through every
    outer level (reference :31): ref_level 0 addresses the outermost level
    whatever the depth."""
    idx = y.row_to_outer().long()
    for level in range(len(y.outer_levels) - 2, -1, -1):
        idx = y.row_to_outer(level).long()[idx]
    return idx


def _mask(data, lens, dtype=None):
    m = torch.arange(data.shape[1], device=data.device)[None, :] \
        < lens[:, None]
    return m if dtype is None else m.to(dtype)


def _feat_mask(data, lens):
    """The validity mask, broadcastable over the feature dims of [b, L,
    *feat]."""
    m = _mask(data, lens, data.dtype)
    return m.reshape(m.shape + (1,) * (data.ndim - 2))


def _vjp_grad(op_type, in_slots=("X",), out_slot="Out"):
    """Grad maker: "<op>_grad" takes the forward inputs and dOut and gives
    the inputs' grads (the DefaultGradOpDescMaker pattern)."""
    def maker(op):
        inputs = {s: op.input(s) for s in in_slots if op.input(s)}
        inputs[out_slot + "@GRAD"] = G(op.output(out_slot))
        outputs = {s + "@GRAD": G(op.input(s))
                   for s in in_slots if op.input(s)}
        return [OpSpec(op_type + "_grad", inputs, outputs, dict(op.attrs))]
    return maker


def _gather_time(x, idx):
    """x: [b, L, *feat], idx: [b, Lo] -> [b, Lo, *feat]."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


# ---------------------------------------------------------------------------
# sequence_pool: AVERAGE / SUM / SQRT / MAX / LAST / FIRST -> dense [b, feat]
# ---------------------------------------------------------------------------

def _sequence_pool_compute(data, lens, pooltype):
    fm = _feat_mask(data, lens)
    n = lens.clamp_min(1).to(data.dtype).reshape(
        (-1,) + (1,) * (data.ndim - 2))
    if pooltype == "SUM":
        return (data * fm).sum(dim=1)
    if pooltype == "AVERAGE":
        return (data * fm).sum(dim=1) / n
    if pooltype == "SQRT":
        return (data * fm).sum(dim=1) / torch.sqrt(n)
    if pooltype == "MAX":
        # amax splits the gradient between equal maxima, as jnp.max's does
        return torch.where(fm > 0, data, -torch.inf).amax(dim=1)
    if pooltype == "LAST":
        last = (lens.long() - 1).clamp_min(0)
        return _gather_time(data, last[:, None])[:, 0]
    if pooltype == "FIRST":
        return data[:, 0]
    raise ValueError(f"unknown pooltype {pooltype!r}")


def _sp_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is not None:
        out.shape = tuple(x.shape[:1]) + tuple(x.shape[2:]) \
            if len(x.shape) > 2 else x.shape
    out.dtype = x.dtype
    out.lod_level = 0


def _windowed_pool(data, lens, k, pooltype):
    """Pooling with stride k (reference :100): one result per window of k
    steps, so the output is a sequence of ceil(len / k) entries."""
    b, L = data.shape[:2]
    feat = tuple(data.shape[2:])
    nw = -(-L // k)
    pad = nw * k - L
    dp = torch.nn.functional.pad(data, (0, 0) * len(feat) + (0, pad))
    w = dp.reshape((b, nw, k) + feat)
    tok = torch.arange(nw * k, device=data.device).reshape(nw, k)[None]
    valid = tok < lens[:, None, None]                        # [b, nw, k]
    vm = valid.reshape(valid.shape + (1,) * len(feat)).to(data.dtype)
    counts = valid.sum(dim=2)                                # [b, nw]
    cm = counts.clamp_min(1).reshape((b, nw) + (1,) * len(feat)) \
        .to(data.dtype)
    if pooltype == "SUM":
        out = (w * vm).sum(dim=2)
    elif pooltype == "AVERAGE":
        out = (w * vm).sum(dim=2) / cm
    elif pooltype == "SQRT":
        out = (w * vm).sum(dim=2) / torch.sqrt(cm)
    elif pooltype == "MAX":
        out = torch.where(vm > 0, w, -torch.inf).amax(dim=2)
        out = torch.where(counts.reshape(cm.shape) > 0, out, 0.0)
    elif pooltype == "FIRST":
        out = w[:, :, 0]
    elif pooltype == "LAST":
        last = (counts - 1).clamp(0, k - 1).long()           # [b, nw]
        idx = last.reshape((b, nw, 1) + (1,) * len(feat)) \
            .expand((b, nw, 1) + feat)
        out = torch.gather(w, 2, idx)[:, :, 0]
    else:
        raise ValueError(f"unknown pooltype {pooltype!r}")
    out_lens = (-(-lens // k)).to(torch.int32)
    return LoDArray(out * _feat_mask(out, out_lens), out_lens)


def _regroup_rows(rows, outer_lens):
    """[n_inner, *feat] rows -> a LoDArray [n_outer, n_inner, *feat]
    grouped by ``outer_lens`` (the TO_SEQUENCE pooling output, reference
    :140)."""
    n = rows.shape[0]
    ends = torch.cumsum(outer_lens.long(), 0)
    owner = torch.searchsorted(ends, torch.arange(n, device=rows.device),
                               right=True)
    pos = torch.arange(n, device=rows.device) - (ends - outer_lens.long())[
        owner]
    out = rows.new_zeros((outer_lens.shape[0], n) + tuple(rows.shape[1:]))
    out = out.index_put((owner, pos), rows)
    return LoDArray(out, outer_lens.to(torch.int32))


@register_op("sequence_pool", infer_shape=_sp_infer,
             grad=_vjp_grad("sequence_pool"))
def sequence_pool(ctx):
    """[b, L, *feat] LoDArray -> dense [b, *feat] (reference :157); with
    ``stride`` a sequence of windows; over nested LoD with agg_level "seq"
    a level-1 sequence of the inner results per outer group."""
    x = _seq(ctx.input("X"))
    pooltype = ctx.attr("pooltype", "AVERAGE")
    stride = int(ctx.attr("stride", 0) or 0)
    if stride > 0:
        ctx.set_output("Out", _windowed_pool(x.data, x.lens, stride,
                                             pooltype))
        return
    pooled = _sequence_pool_compute(x.data, x.lens, pooltype)
    if x.outer_levels and ctx.attr("agg_level", "non-seq") == "seq":
        ctx.set_output("Out", _regroup_rows(pooled, x.outer_levels[-1]))
        return
    ctx.set_output("Out", pooled)


@register_op("sequence_pool_grad")
def sequence_pool_grad(ctx):
    """The vjp of the pooling over each sequence (reference :183)."""
    x = _seq(ctx.input("X"))
    pooltype = ctx.attr("pooltype", "AVERAGE")
    dx, = vjp(lambda d: _sequence_pool_compute(d, x.lens, pooltype),
              [x.data], data_of(ctx.input("Out@GRAD")))
    ctx.set_output("X@GRAD", x.with_data(dx))


# ---------------------------------------------------------------------------
# sequence_softmax: softmax within each sequence (feature dim of size 1)
# ---------------------------------------------------------------------------

def _sequence_softmax_compute(data, lens):
    squeeze = data.ndim == 3 and data.shape[-1] == 1
    d = data[..., 0] if squeeze else data
    m = _mask(d, lens)
    z = torch.where(m, d, -torch.inf)
    z = z - z.amax(dim=1, keepdim=True)
    e = torch.exp(z) * m.to(d.dtype)
    out = e / e.sum(dim=1, keepdim=True).clamp_min(1e-30)
    return out[..., None] if squeeze else out


@register_op("sequence_softmax", infer_shape=same_shape("X", "Out"),
             grad=_vjp_grad("sequence_softmax"))
def sequence_softmax(ctx):
    x = _seq(ctx.input("X"))
    ctx.set_output("Out", x.with_data(
        _sequence_softmax_compute(x.data, x.lens)))


@register_op("sequence_softmax_grad")
def sequence_softmax_grad(ctx):
    x = _seq(ctx.input("X"))
    dx, = vjp(lambda d: _sequence_softmax_compute(d, x.lens), [x.data],
              data_of(ctx.input("Out@GRAD")))
    ctx.set_output("X@GRAD", x.with_data(dx))


# ---------------------------------------------------------------------------
# sequence_expand
# ---------------------------------------------------------------------------

def _se_infer(op, block):
    x = block.var(op.input("X")[0])
    out = block.var(op.output("Out")[0])
    out.shape, out.dtype = x.shape, x.dtype
    # ref_level 0 gives dense rows per inner sequence (lod 0); the default
    # innermost expansion one sequence per x row (lod 1)
    out.lod_level = 0 if op.attrs.get("ref_level", -1) == 0 else 1


def _segment_sum(d, idx, n):
    return d.new_zeros((n,) + tuple(d.shape[1:])).index_add(0, idx, d)


@register_op("sequence_expand", infer_shape=_se_infer, grad=lambda op: [
    OpSpec("sequence_expand_grad",
           {"X": op.input("X"), "Y": op.input("Y"),
            "Out@GRAD": G(op.output("Out"))},
           {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def sequence_expand(ctx):
    """ref_level -1 / 1 (default): x's i-th row tiled along y's i-th
    sequence; a ragged x's i-th sequence repeated y_lens[i] times.
    ref_level 0 over nested y: x's i-th row (or sequence) once per inner
    sequence of y's i-th outermost group (reference :245)."""
    xv = ctx.input("X")
    y = _seq(ctx.input("Y"))
    ref_level = int(ctx.attr("ref_level", -1))
    if ref_level == 0 and y.outer_levels:
        idx = _rows_to_level0(y)
        if isinstance(xv, LoDArray):
            n_outer = y.outer_levels[0].shape[0]
            if xv.data.shape[0] != n_outer:
                raise ValueError(
                    f"sequence_expand ref_level=0: x has {xv.data.shape[0]} "
                    f"sequences but y has {n_outer} outer groups")
            ctx.set_output("Out", LoDArray(xv.data[idx], xv.lens[idx]))
            return
        ctx.set_output("Out", data_of(xv)[idx])
        return
    if isinstance(xv, LoDArray):
        if xv.data.shape[0] != y.lens.shape[0]:
            raise ValueError(
                f"sequence_expand: x has {xv.data.shape[0]} sequences but y "
                f"has {y.lens.shape[0]} reference segments")
        idx = torch.repeat_interleave(
            torch.arange(y.lens.shape[0], device=y.lens.device),
            y.lens.long())
        ctx.set_output("Out", LoDArray(xv.data[idx], xv.lens[idx]))
        return
    x = data_of(xv)
    tiled = x[:, None].expand((x.shape[0], y.max_len) + tuple(x.shape[1:]))
    ctx.set_output("Out", LoDArray(tiled * _feat_mask(tiled, y.lens),
                                   y.lens))


@register_op("sequence_expand_grad")
def sequence_expand_grad(ctx):
    """The expansion's rows summed back onto x's rows (reference :311)."""
    xv = ctx.input("X")
    y = _seq(ctx.input("Y"))
    dy_v = ctx.input("Out@GRAD")
    ref_level = int(ctx.attr("ref_level", -1))
    if ref_level == 0 and y.outer_levels:
        idx = _rows_to_level0(y)
        n_outer = y.outer_levels[0].shape[0]
        if isinstance(xv, LoDArray):
            d = _seq(dy_v).data * _feat_mask(dy_v.data, xv.lens[idx])
            ctx.set_output("X@GRAD", xv.with_data(
                _segment_sum(d, idx, n_outer)))
            return
        ctx.set_output("X@GRAD", _segment_sum(data_of(dy_v), idx, n_outer))
        return
    if isinstance(xv, LoDArray):
        dy = _seq(dy_v)
        idx = torch.repeat_interleave(
            torch.arange(y.lens.shape[0], device=y.lens.device),
            y.lens.long())
        d = dy.data * _feat_mask(dy.data, dy.lens)
        ctx.set_output("X@GRAD", xv.with_data(
            _segment_sum(d, idx, xv.data.shape[0])))
        return
    dy = _seq(dy_v)
    ctx.set_output("X@GRAD", (dy.data * _feat_mask(dy.data, y.lens))
                   .sum(dim=1))


# ---------------------------------------------------------------------------
# sequence_concat: each row's sequences joined along time
# ---------------------------------------------------------------------------

def _seq_concat2(a, al, b, bl):
    out_max = a.shape[1] + b.shape[1]
    pos = torch.arange(out_max, device=a.device)[None, :]
    from_b = pos >= al[:, None]
    ia = pos.clamp_max(a.shape[1] - 1).expand(a.shape[0], out_max)
    ib = (pos - al[:, None]).clamp(0, b.shape[1] - 1)
    ga, gb = _gather_time(a, ia), _gather_time(b, ib)
    out = torch.where(from_b.reshape(from_b.shape + (1,) * (a.ndim - 2)),
                      gb, ga)
    lens = al + bl
    return out * _feat_mask(out, lens), lens


def _sequence_concat_compute(datas, lenss):
    out, lens = datas[0], lenss[0]
    for d, n in zip(datas[1:], lenss[1:]):
        out, lens = _seq_concat2(out, lens, d, n)
    return out, lens


@register_op("sequence_concat", grad=lambda op: [OpSpec(
    "sequence_concat_grad",
    {"X": op.input("X"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def sequence_concat(ctx):
    xs = [_seq(v) for v in ctx.inputs("X")]
    out, lens = _sequence_concat_compute([x.data for x in xs],
                                         [x.lens for x in xs])
    ctx.set_output("Out", LoDArray(out, lens))


@register_op("sequence_concat_grad")
def sequence_concat_grad(ctx):
    xs = [_seq(v) for v in ctx.inputs("X")]
    lenss = [x.lens for x in xs]
    grads = vjp(lambda *ds: _sequence_concat_compute(ds, lenss)[0],
                [x.data for x in xs], data_of(ctx.input("Out@GRAD")))
    ctx.set_outputs("X@GRAD", [x.with_data(g) for g, x in zip(grads, xs)])


# ---------------------------------------------------------------------------
# sequence_reshape: a new feature width, lengths rescaled
# ---------------------------------------------------------------------------

@register_op("sequence_reshape", grad=_vjp_grad("sequence_reshape"))
def sequence_reshape(ctx):
    x = _seq(ctx.input("X"))
    new_dim = int(ctx.attr("new_dim"))
    b, L, D = x.data.shape
    if (L * D) % new_dim:
        raise ValueError(f"sequence_reshape: {L} x {D} does not divide "
                         f"into rows of {new_dim}")
    ctx.set_output("Out", LoDArray(x.data.reshape(b, L * D // new_dim,
                                                  new_dim),
                                   (x.lens * D) // new_dim))


@register_op("sequence_reshape_grad")
def sequence_reshape_grad(ctx):
    x = _seq(ctx.input("X"))
    ctx.set_output("X@GRAD", x.with_data(
        data_of(ctx.input("Out@GRAD")).reshape(x.data.shape)))


# ---------------------------------------------------------------------------
# sequence_slice / sequence_erase / lod_reset
# ---------------------------------------------------------------------------

@register_op("sequence_slice", grad=lambda op: [OpSpec(
    "sequence_slice_grad",
    {"X": op.input("X"), "Offset": op.input("Offset"),
     "Length": op.input("Length"), "Out@GRAD": G(op.output("Out"))},
    {"X@GRAD": G(op.input("X"))}, dict(op.attrs))])
def sequence_slice(ctx):
    """[offset, offset + length) of every sequence (reference :405;
    Offset and Length are [b] or [b, 1])."""
    x = _seq(ctx.input("X"))
    off = data_of(ctx.input("Offset")).reshape(-1).to(torch.int32)
    length = data_of(ctx.input("Length")).reshape(-1).to(torch.int32)
    pos = torch.arange(x.max_len, device=x.data.device)
    idx = (off[:, None] + pos[None, :]).clamp_max(x.max_len - 1)
    out = _gather_time(x.data, idx)
    lens = torch.minimum(length, (x.lens - off).clamp_min(0))
    ctx.set_output("Out", LoDArray(out * _feat_mask(out, lens), lens))


@register_op("sequence_slice_grad")
def sequence_slice_grad(ctx):
    x = _seq(ctx.input("X"))
    off = data_of(ctx.input("Offset")).reshape(-1).to(torch.int32)
    dy = _seq(ctx.input("Out@GRAD"))
    d = dy.data * _feat_mask(dy.data, dy.lens)
    pos = torch.arange(x.max_len, device=x.data.device)[None, :] \
        - off[:, None]
    valid = (pos >= 0) & (pos < dy.max_len)
    dx = _gather_time(d, pos.clamp(0, dy.max_len - 1))
    dx = dx * valid.reshape(valid.shape + (1,) * (dx.ndim - 2)).to(dx.dtype)
    ctx.set_output("X@GRAD", x.with_data(dx))


@register_op("sequence_erase")
def sequence_erase(ctx):
    """Each row without the tokens in attr ``tokens``, compacted in order
    (reference :437)."""
    x = _seq(ctx.input("X"))
    d = x.data
    flatd = d if d.ndim == 2 else d[..., 0]
    tokens = torch.as_tensor(list(ctx.attr("tokens", [])), dtype=d.dtype,
                             device=d.device)
    keep = _mask(flatd, x.lens) & ~torch.isin(flatd, tokens)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    comp = torch.gather(flatd, 1, order)
    lens = keep.sum(dim=1).to(torch.int32)
    comp = comp * _mask(comp, lens, comp.dtype)
    ctx.set_output("Out", LoDArray(comp if d.ndim == 2 else comp[..., None],
                                   lens))


def _lod_repack(data, old_lens, new_lens, new_max):
    """The flat rows of padded ``data`` re-cut under ``new_lens`` (the
    point of lod_reset: the same rows, new offsets, maybe a different
    number of sequences; reference :455)."""
    b, L = data.shape[0], data.shape[1]
    zero = torch.zeros(1, dtype=torch.int64, device=data.device)
    old_off = torch.cat([zero, torch.cumsum(old_lens.long(), 0)])
    new_off = torch.cat([zero, torch.cumsum(new_lens.long(), 0)])
    pos = torch.arange(new_max, device=data.device)
    flat_idx = (new_off[:-1, None] + pos[None, :]).clamp(0, b * L - 1)
    valid = pos[None, :] < new_lens[:, None]
    row = torch.searchsorted(old_off[1:].contiguous(), flat_idx,
                             right=True).clamp(0, b - 1)
    col = (flat_idx - old_off[row]).clamp(0, L - 1)
    gathered = data[row, col]
    mask = valid.reshape(valid.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, gathered, torch.zeros_like(gathered))


@register_op("lod_reset")
def lod_reset(ctx):
    """X's rows under new lengths, taken from Y (a LoDArray's lengths or
    an offsets tensor) or from attr ``target_lod`` (reference :478)."""
    xv = ctx.input("X")
    x = _seq(xv) if isinstance(xv, LoDArray) else None
    data = x.data if x is not None else data_of(xv)
    if ctx.has_input("Y"):
        y = ctx.input("Y")
        if isinstance(y, LoDArray):
            lens, new_max = y.lens, y.data.shape[1]
        else:
            lens = torch.diff(data_of(y).reshape(-1).to(torch.int32))
            new_max = int(lens.max()) if lens.numel() else 0
    else:
        target = np.asarray(ctx.attr("target_lod"), np.int64)
        lens = torch.as_tensor(np.diff(target), dtype=torch.int32,
                               device=data.device)
        new_max = int(np.diff(target).max()) if target.size > 1 else 0
    old_lens = torch.ones((data.shape[0],), dtype=torch.int32,
                          device=data.device) if x is None else x.lens
    n_new, n_old = int(lens.sum()), int(old_lens.sum())
    if n_new != n_old:
        raise ValueError(f"lod_reset: target lod covers {n_new} elements "
                         f"but X holds {n_old}")
    src = data[:, None] if x is None else data
    ctx.set_output("Out", LoDArray(_lod_repack(src, old_lens, lens, new_max),
                                   lens.to(torch.int32)))


# ---------------------------------------------------------------------------
# sequence_conv: a context-window convolution over time
# ---------------------------------------------------------------------------

def _sequence_conv_compute(data, lens, filt, context_length, context_start):
    b, L, D = data.shape
    fm = _feat_mask(data, lens)
    d = data * fm
    pos0 = torch.arange(L, device=data.device)[None, :]
    cols = []
    for j in range(context_length):
        shift = context_start + j
        if shift < 0:
            shifted = torch.nn.functional.pad(d, (0, 0, -shift, 0))[:, :L]
        elif shift > 0:
            shifted = torch.nn.functional.pad(d, (0, 0, 0, shift))[:, shift:]
        else:
            shifted = d
        # steps past a row's own length give zeros: per-sequence padding
        ok = ((pos0 + shift >= 0) & (pos0 + shift < lens[:, None]))
        cols.append(shifted * ok[..., None].to(d.dtype))
    out = torch.matmul(torch.cat(cols, dim=-1), filt)
    return out * fm[..., :1] if fm.shape[-1] != 1 else out * fm


def _sc_infer(op, block):
    x = block.var(op.input("X")[0])
    f = block.var(op.input("Filter")[0])
    out = block.var(op.output("Out")[0])
    if x.shape is not None and f.shape is not None:
        out.shape = tuple(x.shape[:-1]) + (f.shape[1],)
    out.dtype = x.dtype
    out.lod_level = x.lod_level


def _conv_grad_maker(op):
    return [OpSpec(op.type + "_grad",
                   {"X": op.input("X"), "Filter": op.input("Filter"),
                    "Out@GRAD": G(op.output("Out"))},
                   {"X@GRAD": G(op.input("X")),
                    "Filter@GRAD": G(op.input("Filter"))}, dict(op.attrs))]


def _context(ctx):
    cl = int(ctx.attr("contextLength"))
    return cl, int(ctx.attr("contextStart", -((cl - 1) // 2)))


@register_op("sequence_conv", infer_shape=_sc_infer, grad=_conv_grad_maker)
def sequence_conv(ctx):
    x = _seq(ctx.input("X"))
    out = _sequence_conv_compute(x.data, x.lens,
                                 data_of(ctx.input("Filter")), *_context(ctx))
    ctx.set_output("Out", LoDArray(out, x.lens))


@register_op("sequence_conv_grad")
def sequence_conv_grad(ctx):
    x = _seq(ctx.input("X"))
    cl, cs = _context(ctx)
    dy = _seq(ctx.input("Out@GRAD")).data
    dx, df = vjp(lambda d, f: _sequence_conv_compute(d, x.lens, f, cl, cs),
                 [x.data, data_of(ctx.input("Filter"))],
                 dy * _feat_mask(dy, x.lens))
    ctx.set_output("X@GRAD", x.with_data(dx))
    ctx.set_output("Filter@GRAD", df)


# ---------------------------------------------------------------------------
# row_conv: the lookahead convolution of DeepSpeech2
# ---------------------------------------------------------------------------

def _row_conv_compute(data, lens, filt):
    k = filt.shape[0]                      # future context + 1
    L = data.shape[1]
    d = data * _feat_mask(data, lens)
    pos0 = torch.arange(L, device=data.device)[None, :]
    out = torch.zeros_like(d)
    for j in range(k):
        shifted = torch.nn.functional.pad(d, (0, 0, 0, j))[:, j:] if j else d
        ok = (pos0 + j < lens[:, None])[..., None].to(d.dtype)
        out = out + shifted * ok * filt[j][None, None, :]
    return out


@register_op("row_conv", grad=_conv_grad_maker)
def row_conv(ctx):
    x = _seq(ctx.input("X"))
    ctx.set_output("Out", LoDArray(
        _row_conv_compute(x.data, x.lens, data_of(ctx.input("Filter"))),
        x.lens))


@register_op("row_conv_grad")
def row_conv_grad(ctx):
    x = _seq(ctx.input("X"))
    dy = _seq(ctx.input("Out@GRAD")).data
    dx, df = vjp(lambda d, f: _row_conv_compute(d, x.lens, f),
                 [x.data, data_of(ctx.input("Filter"))],
                 dy * _feat_mask(dy, x.lens))
    ctx.set_output("X@GRAD", x.with_data(dx))
    ctx.set_output("Filter@GRAD", df)
