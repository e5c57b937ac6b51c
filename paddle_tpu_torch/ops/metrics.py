"""Metric ops (counterpart of paddle_tpu/ops/metrics.py): ``accuracy``
(reference :19), the thresholded ``auc`` (reference :47, its area from the
stat vectors by ``auc_from_stats``, :34), ``precision_recall`` (reference
:78) and ``chunk_eval`` (reference :179) with its chunk extraction
``extract_chunks`` (reference :130).

``accuracy``, ``auc`` and ``precision_recall`` stay on the device: no host
read or copy. ``chunk_eval`` walks tag sequences on the host, as the
reference does (its kernel is CPU-only too): it reads both inputs to the
host in one copy, one sync a call, and sends its results back in one
asynchronous copy; keep it off a step loop that does not fetch it.
Dtypes: Correct/Total int32, the chunk counts int64, the rates float32.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op
from .common import data_of


@register_op("accuracy")
def accuracy(ctx):
    """Out = the share of rows whose top-k Indices hold the Label, with
    the Correct and Total counts."""
    indices = data_of(ctx.input("Indices"))
    label = data_of(ctx.input("Label")).reshape(-1, 1)
    correct = torch.any(indices == label, dim=1).sum().to(torch.int32)
    total = indices.shape[0]
    ctx.set_output("Accuracy", (correct.float() / total).reshape(()))
    ctx.set_output("Correct", correct.reshape(()))
    ctx.set_output("Total", torch.full((), total, dtype=torch.int32,
                                       device=indices.device))


def auc_from_stats(tp, fn, tn, fp, curve="ROC"):
    """Trapezoidal area under the thresholded curve (reference :34)."""
    eps = 1e-12
    if curve == "PR":
        x = tp / torch.clamp_min(tp + fn, eps)          # recall
        y = tp / torch.clamp_min(tp + fp, eps)          # precision
    else:
        x = fp / torch.clamp_min(fp + tn, eps)          # fpr
        y = tp / torch.clamp_min(tp + fn, eps)          # tpr
    dx = x[:-1] - x[1:]           # thresholds ascending -> x descending
    return torch.sum(dx * (y[:-1] + y[1:]) / 2.0)


@register_op("auc")
def auc(ctx):
    """Batch AUC of prediction column 0 against binary labels at
    ``num_thresholds`` float32 thresholds (-eps, i/(n-1), 1+eps), with the
    TP/FN/TN/FP stat vectors an evaluator accumulates."""
    pred = data_of(ctx.input("Out"))
    label = data_of(ctx.input("Label")).reshape(-1)
    n = int(ctx.attr("num_thresholds", 200))
    eps = 1e-7
    dev = pred.device
    inner = torch.arange(1, n - 1, dtype=torch.float32, device=dev) / (n - 1)
    thresholds = torch.cat([
        torch.full((1,), -eps, dtype=torch.float32, device=dev), inner,
        torch.full((1,), 1.0 + eps, dtype=torch.float32, device=dev)])
    score = pred[:, 0] if pred.ndim == 2 else pred.reshape(-1)
    pos = (label > 0)[None, :]
    above = score[None, :] >= thresholds[:, None]       # [T, N]
    tp = (above & pos).sum(1).float()
    fn = (~above & pos).sum(1).float()
    fp = (above & ~pos).sum(1).float()
    tn = (~above & ~pos).sum(1).float()
    for slot, v in (("TPOut", tp), ("FNOut", fn), ("TNOut", tn),
                    ("FPOut", fp)):
        ctx.set_output(slot, v)
    ctx.set_output("AUC", auc_from_stats(
        tp, fn, tn, fp, ctx.attr("curve", "ROC")).reshape(()))


def _metrics6(st):
    """Macro and micro precision, recall and F1 of [C, 4] (TP, FP, TN, FN)
    counts, a rate of 1 where its denominator is 0 (reference :104)."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]
    eps = 1e-12

    def rate(num, den):
        return torch.where(den > 0, num / torch.clamp_min(den, eps),
                           torch.ones_like(num))

    def f1(p, r):
        return torch.where(p + r > 0, 2 * p * r / torch.clamp_min(p + r, eps),
                           torch.zeros_like(p))

    prec, rec = rate(tp, tp + fp), rate(tp, tp + fn)
    tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
    mprec, mrec = rate(tps, tps + fps), rate(tps, tps + fns)
    return torch.stack([prec.mean(), rec.mean(), f1(prec, rec).mean(),
                        mprec, mrec, f1(mprec, mrec)])


@register_op("precision_recall")
def precision_recall(ctx):
    """Per-class TP/FP/TN/FN of Indices against Labels (weighted by
    Weights), the batch's and the running (StatesInfo + batch) macro and
    micro metrics, and the running [C, 4] state."""
    idx = data_of(ctx.input("Indices")).reshape(-1)
    labels = data_of(ctx.input("Labels")).reshape(-1)
    c = int(ctx.attr("class_number"))
    if ctx.has_input("Weights"):
        w = data_of(ctx.input("Weights")).reshape(-1).float()
    else:
        w = torch.ones(idx.shape[0], dtype=torch.float32, device=idx.device)
    if ctx.has_input("StatesInfo"):
        states = data_of(ctx.input("StatesInfo"))
    else:
        states = torch.zeros((c, 4), dtype=torch.float32, device=idx.device)
    cls = torch.arange(c, device=idx.device)
    pred_is = idx[None, :] == cls[:, None]          # [C, N]
    lab_is = labels[None, :] == cls[:, None]
    wf = w[None, :]
    batch = torch.stack([((pred_is & lab_is) * wf).sum(1),
                         ((pred_is & ~lab_is) * wf).sum(1),
                         ((~pred_is & ~lab_is) * wf).sum(1),
                         ((~pred_is & lab_is) * wf).sum(1)], dim=1)
    accum = states + batch
    ctx.set_output("BatchMetrics", _metrics6(batch))
    ctx.set_output("AccumMetrics", _metrics6(accum))
    ctx.set_output("AccumStatesInfo", accum)


def extract_chunks(tags, scheme, num_chunk_types, excluded=()):
    """The set of (begin, end, type) chunks of a tag sequence (reference
    :130, chunk_eval_op.h GetSegments). Schemes: IOB (tag = type*2 +
    {0: B, 1: I}), IOE (type*2 + {0: I, 1: E}), IOBES (type*4 + {B, I, E,
    S}), plain (tag == type). A tag out of range is Outside."""
    chunks = []
    start = ctype = None

    def close(end):
        nonlocal start, ctype
        if start is not None and ctype not in excluded:
            chunks.append((start, end, ctype))
        start = ctype = None

    width = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}.get(scheme)
    if width is None:
        raise ValueError(f"unknown chunk scheme {scheme!r}")
    for i, t in enumerate(int(t) for t in tags):
        if not 0 <= t < num_chunk_types * width:
            close(i - 1)
            continue
        ttype = t // width
        if scheme == "plain":
            if start is not None and ttype != ctype:
                close(i - 1)
            if start is None:
                start, ctype = i, ttype
            continue
        pos = {"IOB": "BI", "IOE": "IE", "IOBES": "BIES"}[scheme][t % width]
        if pos in ("B", "S") or (start is not None and ttype != ctype):
            close(i - 1)
        if start is None:
            start, ctype = i, ttype
        if pos in ("E", "S"):
            close(i)
    close(len(tags) - 1)
    return set(chunks)


def _host_sequences(inf_v, lab_v):
    """Both inputs' sequences as host lists, read in one copy."""
    def parts(v):
        if isinstance(v, LoDArray):
            return v.data.reshape(v.data.shape[0], -1), v.lens
        return data_of(v).reshape(1, -1), None

    (inf, inf_lens), (lab, lab_lens) = parts(inf_v), parts(lab_v)
    pieces = [inf.reshape(-1).long(), lab.reshape(-1).long()] + [
        lens.long() for lens in (inf_lens, lab_lens) if lens is not None]
    host = torch.cat(pieces).cpu().numpy()
    out, at = [], 0
    for t in (inf, lab):
        out.append(host[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    seqs = []
    for data, lens in zip(out, (inf_lens, lab_lens)):
        if lens is None:
            seqs.append([data[0]])
        else:
            n = data.shape[0]
            lens_h = host[at:at + n]
            at += n
            seqs.append([data[i, :lens_h[i]] for i in range(n)])
    return seqs


@register_op("chunk_eval")
def chunk_eval(ctx):
    """Chunking precision, recall and F1 of Inference against Label, and
    the three chunk counts (reference :179)."""
    scheme = ctx.attr("chunk_scheme", "IOB")
    num_types = int(ctx.attr("num_chunk_types"))
    excluded = tuple(ctx.attr("excluded_chunk_types", []) or [])
    infs, labs = _host_sequences(ctx.input("Inference"), ctx.input("Label"))
    n_inf = n_lab = n_correct = 0
    for inf, lab in zip(infs, labs):
        ic = extract_chunks(inf, scheme, num_types, excluded)
        lc = extract_chunks(lab, scheme, num_types, excluded)
        n_inf += len(ic)
        n_lab += len(lc)
        n_correct += len(ic & lc)
    p = n_correct / n_inf if n_inf else 0.0
    r = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    # the six results cross to the device in one asynchronous copy
    vals = torch.tensor([p, r, f1, n_inf, n_lab, n_correct],
                        dtype=torch.float64)
    if ctx.device.type == "cuda":
        vals = vals.pin_memory()
    vals = vals.to(ctx.device, non_blocking=True)
    for i, slot in enumerate(("Precision", "Recall", "F1-Score")):
        ctx.set_output(slot, vals[i:i + 1].float())
    for i, slot in enumerate(("NumInferChunks", "NumLabelChunks",
                              "NumCorrectChunks"), 3):
        ctx.set_output(slot, vals[i:i + 1].long())
