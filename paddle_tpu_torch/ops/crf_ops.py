"""The linear-chain CRF ops (counterpart of paddle_tpu/ops/crf_ops.py):
``linear_chain_crf`` (reference :101), its grad (reference :109) and the
Viterbi ``crf_decoding`` (reference :121).

Transition is [D+2, D]: row 0 the start scores, row 1 the end scores, rows
2.. the [D, D] tag-to-tag scores (``_crf_nll``, reference :26). Every
sequence of the padded LoD batch runs one recursion together; steps past a
row's length leave its carries as they are (``t < lens``). The recursion
is a host loop of L steps, each a few device ops. The grad is autograd of
the same recursion (``ops/common.py::vjp``), as the reference takes
``jax.vjp`` of its scan. Viterbi ties go to the lowest tag, as
``jnp.argmax`` and ``torch.argmax`` both pick.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of, vjp


def _crf_nll(emission, lens, labels, w):
    """Negative log-likelihood per sequence, [b, 1]: log Z − the gold
    path's score. emission [b, L, D]; lens [b]; labels [b, L] int64; w
    [D+2, D]."""
    b, L, _ = emission.shape
    start, end, trans = w[0], w[1], w[2:]
    rows = torch.arange(b, device=emission.device)
    y0 = labels[:, 0]
    alpha = start[None, :] + emission[:, 0]
    gold = start[y0] + emission[rows, 0, y0]
    one = lens == 1
    logz = torch.where(one, torch.logsumexp(alpha + end[None, :], dim=1),
                       torch.zeros_like(gold))
    gold_end = torch.where(one, end[y0], torch.zeros_like(gold))
    prev_y = y0
    for t in range(1, L):
        xt, yt = emission[:, t], labels[:, t]
        alive = t < lens
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + xt
        alpha = torch.where(alive[:, None], nxt, alpha)
        step = xt[rows, yt] + trans[prev_y, yt]
        gold = gold + torch.where(alive, step, torch.zeros_like(step))
        last = t == lens - 1
        logz = torch.where(
            last, torch.logsumexp(alpha + end[None, :], dim=1), logz)
        gold_end = torch.where(last, end[yt], gold_end)
        prev_y = torch.where(alive, yt, prev_y)
    return (logz - (gold + gold_end))[:, None]


def _crf_grad_maker(op):
    return [OpSpec(
        "linear_chain_crf_grad",
        {"Emission": op.input("Emission"),
         "Transition": op.input("Transition"), "Label": op.input("Label"),
         "LogLikelihood@GRAD": G(op.output("LogLikelihood"))},
        {"Emission@GRAD": G(op.input("Emission")),
         "Transition@GRAD": G(op.input("Transition"))}, dict(op.attrs))]


def _emission_parts(ctx, op_type):
    ev = ctx.input("Emission")
    if not isinstance(ev, LoDArray):
        raise TypeError(f"{op_type} expects a LoD emission input")
    return ev


def _labels(ctx):
    labels = data_of(ctx.input("Label"))
    if labels.ndim == 3:
        labels = labels[..., 0]
    return labels.long()


@register_op("linear_chain_crf", grad=_crf_grad_maker)
def linear_chain_crf(ctx):
    ev = _emission_parts(ctx, "linear_chain_crf")
    ctx.set_output("LogLikelihood", _crf_nll(
        ev.data, ev.lens, _labels(ctx), data_of(ctx.input("Transition"))))


@register_op("linear_chain_crf_grad")
def linear_chain_crf_grad(ctx):
    ev = _emission_parts(ctx, "linear_chain_crf")
    labels = _labels(ctx)
    de, dw = vjp(lambda e, t: _crf_nll(e, ev.lens, labels, t),
                 (ev.data, data_of(ctx.input("Transition"))),
                 data_of(ctx.input("LogLikelihood@GRAD")))
    ctx.set_output("Emission@GRAD", ev.with_data(de))
    ctx.set_output("Transition@GRAD", dw)


@register_op("crf_decoding")
def crf_decoding(ctx):
    """The best tag path of each sequence (crf_decoding_op.h) as an int64
    LoDArray [b, L, 1]; with a Label input, 0/1 per token where the path
    equals it. Past a row's length the forward keeps its carry and the
    walk back keeps its tag."""
    ev = _emission_parts(ctx, "crf_decoding")
    w = data_of(ctx.input("Transition"))
    start, end, trans = w[0], w[1], w[2:]
    x, lens = ev.data, ev.lens
    score = start[None, :] + x[:, 0]
    ptrs, alives = [], []
    for t in range(1, x.shape[1]):
        cand = score[:, :, None] + trans[None, :, :]      # [b, i, j]
        best, arg = torch.max(cand, dim=1)
        alive = (t < lens)[:, None]
        score = torch.where(alive, best + x[:, t], score)
        ptrs.append(arg)
        alives.append(alive[:, 0])
    tag = torch.argmax(score + end[None, :], dim=1)
    rows = torch.arange(x.shape[0], device=x.device)
    path = [tag]
    for arg, alive in zip(reversed(ptrs), reversed(alives)):
        tag = torch.where(alive, arg[rows, tag], tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)[..., None]   # [b, L, 1] int64
    if ctx.has_input("Label"):
        labels = data_of(ctx.input("Label"))
        if labels.ndim == 2:
            labels = labels[..., None]
        path = (path == labels.long()).long()
    ctx.set_output("ViterbiPath", ev.with_data(path))
