"""CTC ops: warpctc (the CTC loss) and its grad, ctc_align and
edit_distance (counterpart of paddle_tpu/ops/ctc_ops.py: ``warpctc``
:186, ``warpctc_grad`` :197, ``ctc_align`` :215, ``edit_distance`` :239).

warpctc runs over padded LoD logits [b, T, C] and padded LoD labels
[b, U(, 1)]. Float32 with more than one frame takes the kernel route
(``ops/cuda/ctc.py``: the log-softmax in torch, then one launch from the
log-probabilities and the labels); everything else, and every call under
``kernel_tier=torch``, the float32 scan. The grad op launches the
backward kernel directly, without the forward; on the scan route it is
autograd through the recomputed scan, as the reference's ``jax.vjp`` is.
``norm_by_times`` scales only the gradient (reference :190-211).
ctc_align and edit_distance are plain ops, as in the reference.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op, OpSpec, G
from .common import data_of, vjp
from .cuda import use_kernel
from .cuda import ctc as ctck


def _ctc_inputs(ctx):
    """(logits LoDArray, labels [b, U] int, label lengths) of the op."""
    lv = ctx.input("Logits")
    if not isinstance(lv, LoDArray):
        raise TypeError("warpctc expects LoD logits")
    lab = ctx.input("Label")
    if not isinstance(lab, LoDArray):
        raise TypeError("warpctc expects a LoD label")
    labels = lab.data
    if labels.ndim == 3:
        labels = labels[..., 0]
    return lv, labels.long(), lab.lens


def _on_kernel(logits, labels):
    """Does this call take the kernel route (and count an unsupported
    shape)?"""
    _, T, C = logits.shape
    return use_kernel("ctc", ctck.supported(
        T, ctck.label_positions(labels.shape[1]), C, logits.dtype),
        logits.device)


def _ctc_loss_scan(logits, x_lens, labels, y_lens, blank):
    """The reference's ``_ctc_loss_scan`` (:41): loss [b, 1]."""
    return ctck.ctc_scan(torch.log_softmax(logits, dim=-1), x_lens, labels,
                         y_lens, blank)


def _warpctc_grad_maker(op):
    return [OpSpec(
        "warpctc_grad",
        {"Logits": op.input("Logits"), "Label": op.input("Label"),
         "Loss@GRAD": G(op.output("Loss"))},
        {"Logits@GRAD": G(op.input("Logits"))}, dict(op.attrs))]


@register_op("warpctc", grad=_warpctc_grad_maker)
def warpctc(ctx):
    lv, labels, y_lens = _ctc_inputs(ctx)
    blank = int(ctx.attr("blank", 0))
    logits, x_lens = lv.data, lv.lens
    if _on_kernel(logits, labels):
        loss = ctck.ctc_alpha(torch.log_softmax(logits, dim=-1), x_lens,
                              labels, y_lens, blank)
    else:
        loss = _ctc_loss_scan(logits, x_lens, labels, y_lens, blank)
    # norm_by_times scales only the gradient (reference :190-193)
    ctx.set_output("Loss", loss)


@register_op("warpctc_grad")
def warpctc_grad(ctx):
    lv, labels, y_lens = _ctc_inputs(ctx)
    blank = int(ctx.attr("blank", 0))
    logits, x_lens = lv.data, lv.lens
    d = data_of(ctx.input("Loss@GRAD"))
    if _on_kernel(logits, labels):
        dlogits = ctck.ctc_loss_bwd(torch.log_softmax(logits, dim=-1),
                                    x_lens, labels, y_lens, blank, d)
    else:
        dlogits, = vjp(lambda lg: _ctc_loss_scan(lg, x_lens, labels, y_lens,
                                                 blank), [logits], d)
    if ctx.attr("norm_by_times", False):
        # 1/T on the logits gradient only (reference :208-211)
        dlogits = dlogits / x_lens.clamp_min(1)[:, None, None] \
            .to(dlogits.dtype)
    ctx.set_output("Logits@GRAD", LoDArray(dlogits, x_lens))


@register_op("ctc_align")
def ctc_align(ctx):
    """Merge repeated tokens, drop blanks, compact (reference :215-236)."""
    x = ctx.input("Input")
    if not isinstance(x, LoDArray):
        raise TypeError("ctc_align expects LoD input")
    blank = int(ctx.attr("blank", 0))
    d = x.data
    flat = d if d.ndim == 2 else d[..., 0]
    pos = torch.arange(flat.shape[1], device=flat.device)
    keep = (pos[None, :] < x.lens[:, None]) & (flat != blank)
    if bool(ctx.attr("merge_repeated", True)):
        prev = torch.nn.functional.pad(flat, (1, 0), value=-1)[:, :-1]
        keep = keep & (flat != prev)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    comp = torch.gather(flat, 1, order)
    lens = keep.sum(dim=1).to(torch.int32)
    comp = comp * (pos[None, :] < lens[:, None]).to(comp.dtype)
    ctx.set_output("Output", LoDArray(comp if d.ndim == 2 else comp[..., None],
                                      lens))


@register_op("edit_distance")
def edit_distance(ctx):
    """Levenshtein distance per (hypothesis, reference) pair (reference
    :239-282); ``normalized`` divides by the reference's length. One
    vectorised row update per hypothesis token: the left-to-right min of
    a DP row is a running minimum, ``j + cummin(v_j - j)``."""
    hyp = ctx.input("Hyps")
    ref = ctx.input("Refs")
    if not isinstance(hyp, LoDArray) or not isinstance(ref, LoDArray):
        raise TypeError("edit_distance expects LoD inputs")
    h = hyp.data if hyp.data.ndim == 2 else hyp.data[..., 0]
    r = ref.data if ref.data.ndim == 2 else ref.data[..., 0]
    hl, rl = hyp.lens, ref.lens
    b, R = r.shape
    cols = torch.arange(R + 1, dtype=torch.float32, device=r.device)
    row = cols[None, :].expand(b, R + 1)
    for i in range(h.shape[1]):
        sub_or_match = row[:, :-1] + (r != h[:, i:i + 1]).to(torch.float32)
        new_tail = torch.minimum(sub_or_match, row[:, 1:] + 1.0)
        first = row[:, :1] + 1.0
        # val_j = min(new_tail_j, val_{j-1} + 1), val_0 = first
        v = torch.cat([first, new_tail], dim=1) - cols[None, :]
        new_row = torch.cummin(v, dim=1).values + cols[None, :]
        row = torch.where((i < hl)[:, None], new_row, row)
    dist = torch.gather(row, 1, rl.long()[:, None])[:, 0]
    if ctx.attr("normalized", False):
        dist = dist / rl.clamp_min(1).to(dist.dtype)
    ctx.set_output("Out", dist[:, None])
    ctx.set_output("SequenceNum", torch.tensor([b], dtype=torch.int32,
                                               device=r.device))
