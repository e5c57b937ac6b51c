"""The SSD op family: iou_similarity, prior_box, box_coder,
bipartite_match, target_assign, mine_hard_examples, multiclass_nms and
roi_pool (counterpart of paddle_tpu/ops/detection_ops.py :55, :83, :146,
:241, :271, :294, :358 and :409).

Plain PyTorch on the tensors' own device: no op copies to the host, and no
op reads a value back to the host image by image. The vectorisable ops are
broadcasts. The two greedy ones are loops, each step vectorised over
every image (and class):

* bipartite_match takes min(rows, cols) steps, each binding the largest
  remaining entry of every image's distance matrix;
* multiclass_nms takes the score-sorted candidates of every (image,
  class) pair at once, and only the first ``min(nms_top_k, P)`` of them:
  the reference's NMSFast keeps nothing past that index (its ``i < k``
  guard). Instead of walking them one by one it iterates the greedy
  walk's defining equation to its fixed point (``nms_keep``), all
  candidates at once, the ``eta``-adaptive threshold exact.

Sorts are stable, so ties break by index as ``jnp.argsort`` and
``lax.top_k`` break them. multiclass_nms returns the reference's fixed
[b, keep_top_k, 6] rows, label -1 past each image's count, with the counts
as the LoD lengths.
"""

from __future__ import annotations

import torch

from ..core.lod import LoDArray
from ..core.registry import register_op
from .common import data_of


# ---------------------------------------------------------------------------
# iou_similarity
# ---------------------------------------------------------------------------

def iou_matrix(x, y):
    """x [..., N, 4], y [..., M, 4] -> [..., N, M] Jaccard overlap of
    normalized boxes (reference :36)."""
    def area(b):
        return torch.clamp_min(b[..., 2] - b[..., 0], 0) * \
            torch.clamp_min(b[..., 3] - b[..., 1], 0)
    xi = x[..., :, None, :]
    yi = y[..., None, :, :]
    iw = torch.clamp_min(torch.minimum(xi[..., 2], yi[..., 2])
                         - torch.maximum(xi[..., 0], yi[..., 0]), 0.0)
    ih = torch.clamp_min(torch.minimum(xi[..., 3], yi[..., 3])
                         - torch.maximum(xi[..., 1], yi[..., 1]), 0.0)
    inter = iw * ih
    union = area(xi) + area(yi) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


@register_op("iou_similarity")
def iou_similarity(ctx):
    xv = ctx.input("X")
    x, y = data_of(xv), data_of(ctx.input("Y"))
    out = iou_matrix(x, y)
    ctx.set_output("Out", LoDArray(out, xv.lens)
                   if isinstance(xv, LoDArray) else out)


# ---------------------------------------------------------------------------
# prior_box
# ---------------------------------------------------------------------------

def expand_aspect_ratios(aspect_ratios, flip):
    """[1.0] and each new ratio (and its inverse under ``flip``), the
    duplicates dropped (reference :70)."""
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(ar)
        if flip:
            out.append(1.0 / ar)
    return out


@register_op("prior_box")
def prior_box(ctx):
    """Anchor boxes of every feature-map cell (prior_box_op.h): per min
    size, [min, sqrt(min·max) if max, min·√ar for each ar ≠ 1], centred at
    (index + offset)·step, normalized by the image size, optionally
    clipped. Boxes and Variances are [fh, fw, priors, 4]."""
    feat = data_of(ctx.input("Input"))
    img = data_of(ctx.input("Image"))
    min_sizes = [float(s) for s in ctx.attr("min_sizes")]
    max_sizes = [float(s) for s in ctx.attr("max_sizes", []) or []]
    ars = expand_aspect_ratios(
        [float(a) for a in ctx.attr("aspect_ratios", [1.0])],
        bool(ctx.attr("flip", False)))
    variances = [float(v) for v in ctx.attr("variances",
                                            [0.1, 0.1, 0.2, 0.2])]
    offset = float(ctx.attr("offset", 0.5))
    ih, iw = img.shape[2], img.shape[3]
    fh, fw = feat.shape[2], feat.shape[3]
    step_w = float(ctx.attr("step_w", 0.0)) or iw / fw
    step_h = float(ctx.attr("step_h", 0.0)) or ih / fh

    half = []
    for s, mn in enumerate(min_sizes):
        half.append((mn / 2.0, mn / 2.0))
        if max_sizes:
            mx = (mn * max_sizes[s]) ** 0.5
            half.append((mx / 2.0, mx / 2.0))
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            half.append((mn * ar ** 0.5 / 2.0, mn / ar ** 0.5 / 2.0))
    dev = feat.device
    half = torch.tensor(half, dtype=torch.float32, device=dev)
    n = half.shape[0]
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) \
        * step_w
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) \
        * step_h
    cxg = cx[None, :, None].expand(fh, fw, n)
    cyg = cy[:, None, None].expand(fh, fw, n)
    bw, bh = half[None, None, :, 0], half[None, None, :, 1]
    # by a tensor, not a Python number: CUDA multiplies by the reciprocal
    # of a scalar divisor, one rounding off the CPU's quotient
    size = torch.tensor([iw, ih, iw, ih], dtype=torch.float32, device=dev)
    boxes = torch.stack([cxg - bw, cyg - bh, cxg + bw, cyg + bh],
                        dim=-1) / size
    if ctx.attr("clip", False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variances, dtype=torch.float32, device=dev)
    ctx.set_output("Boxes", boxes)
    ctx.set_output("Variances", var.expand(fh, fw, n, 4).contiguous())


# ---------------------------------------------------------------------------
# box_coder
# ---------------------------------------------------------------------------

def _center_size(b):
    return ((b[..., 2] + b[..., 0]) / 2, (b[..., 3] + b[..., 1]) / 2,
            b[..., 2] - b[..., 0], b[..., 3] - b[..., 1])


@register_op("box_coder")
def box_coder(ctx):
    """encode_center_size / decode_center_size (box_coder_op.h). Encode:
    targets [N, 4] against priors [M, 4] -> [N, M, 4] offsets, or targets
    [b, M, 4] already gathered per prior -> [b, M, 4] (ssd_loss's aligned
    form). Decode: offsets [N, M, 4] (or [N, 4]) -> corner boxes."""
    prior = data_of(ctx.input("PriorBox"))
    pvar = data_of(ctx.input("PriorBoxVar")) \
        if ctx.has_input("PriorBoxVar") \
        else torch.ones((prior.shape[0], 4), dtype=torch.float32,
                        device=prior.device)
    tv = ctx.input("TargetBox")
    target = data_of(tv)
    pcx, pcy, pw, ph = (v[None, :] for v in _center_size(prior))
    pv = [pvar[None, :, i] for i in range(4)]
    if ctx.attr("code_type", "encode_center_size") == "encode_center_size":
        if target.ndim == 3:
            tcx, tcy, tw, th = _center_size(target)
            out = torch.stack([
                (tcx - pcx) / pw / pv[0], (tcy - pcy) / ph / pv[1],
                torch.log(torch.clamp_min(torch.abs(tw / pw), 1e-10))
                / pv[2],
                torch.log(torch.clamp_min(torch.abs(th / ph), 1e-10))
                / pv[3]], dim=-1)
            ctx.set_output("OutputBox", out)
            return
        tcx, tcy, tw, th = (v[:, None] for v in _center_size(target))
        out = torch.stack([
            (tcx - pcx) / pw / pv[0], (tcy - pcy) / ph / pv[1],
            torch.log(torch.abs(tw / pw)) / pv[2],
            torch.log(torch.abs(th / ph)) / pv[3]], dim=-1)
    else:
        t = target if target.ndim == 3 else target[:, None, :]
        cx = pv[0] * t[..., 0] * pw + pcx
        cy = pv[1] * t[..., 1] * ph + pcy
        w = torch.exp(pv[2] * t[..., 2]) * pw
        h = torch.exp(pv[3] * t[..., 3]) * ph
        out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                          dim=-1)
    ctx.set_output("OutputBox", LoDArray(out, tv.lens)
                   if isinstance(tv, LoDArray) else out)


# ---------------------------------------------------------------------------
# bipartite_match
# ---------------------------------------------------------------------------

def bipartite_match_batch(dist, valid_rows):
    """Greedy global-max matching of every image at once
    (bipartite_match_op.cc:59-103): min(rows, cols) steps, each binding,
    per image, the largest entry among unused rows and columns (at least
    1e-6) where it is positive. dist [b, rows, cols], valid_rows [b, rows]
    masks padded LoD rows. Returns (match index int32, match dist) [b,
    cols]."""
    b, rows, cols = dist.shape
    dev = dist.device
    idx = torch.full((b, cols), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros((b, cols), dtype=dist.dtype, device=dev)
    row_used = ~valid_rows
    col_used = torch.zeros((b, cols), dtype=torch.bool, device=dev)
    neg = torch.full((), -1.0, dtype=dist.dtype, device=dev)
    small = dist < 1e-6
    bi = torch.arange(b, device=dev)
    for _ in range(min(rows, cols)):
        masked = torch.where(row_used[:, :, None] | col_used[:, None, :]
                             | small, neg, dist)
        best, flat = masked.reshape(b, -1).max(dim=1)
        r, c = flat // cols, flat % cols
        ok = best > 0
        idx[bi, c] = torch.where(ok, r.to(torch.int32), idx[bi, c])
        mdist[bi, c] = torch.where(ok, best, mdist[bi, c])
        row_used[bi, r] |= ok
        col_used[bi, c] |= ok
    return idx, mdist


def argmax_match_extend(dist, idx, mdist, valid_rows, thresh):
    """ArgMaxMatch (bipartite_match_op.cc:105-135): an unmatched column
    takes its best row where the overlap reaches ``thresh`` (and 1e-6)."""
    masked = torch.where(valid_rows[:, :, None], dist,
                         torch.full((), -1.0, dtype=dist.dtype,
                                    device=dist.device))
    best, best_row = masked.max(dim=1)
    take = (idx == -1) & (best >= thresh) & (best >= 1e-6)
    return (torch.where(take, best_row.to(torch.int32), idx),
            torch.where(take, best, mdist))


@register_op("bipartite_match")
def bipartite_match(ctx):
    dv = ctx.input("DistMat")
    dist = data_of(dv)
    lens = dv.lens if isinstance(dv, LoDArray) and dist.ndim == 3 else None
    if dist.ndim == 2:
        dist = dist[None]
    b, rows, _ = dist.shape
    pos = torch.arange(rows, device=dist.device)[None, :]
    valid = pos < lens[:, None] if lens is not None \
        else torch.ones((b, rows), dtype=torch.bool, device=dist.device)
    idx, mdist = bipartite_match_batch(dist, valid)
    if ctx.attr("match_type", "bipartite") == "per_prediction":
        idx, mdist = argmax_match_extend(
            dist, idx, mdist, valid, float(ctx.attr("dist_threshold", 0.5)))
    ctx.set_output("ColToRowMatchIndices", idx)
    ctx.set_output("ColToRowMatchDist", mdist)


# ---------------------------------------------------------------------------
# target_assign
# ---------------------------------------------------------------------------

@register_op("target_assign")
def target_assign(ctx):
    """out[i, j] = X[i, match[i, j]] where the match is >= 0, else
    ``mismatch_value``; OutWeight 1 where matched (target_assign_op.h). X is
    the padded per-image rows [b, n, K]."""
    x = data_of(ctx.input("X"))
    match = data_of(ctx.input("MatchIndices")).long()
    matched = match >= 0
    bi = torch.arange(x.shape[0], device=x.device)[:, None]
    gathered = x[bi, torch.clamp_min(match, 0)]
    fill = torch.full((), ctx.attr("mismatch_value", 0), dtype=x.dtype,
                      device=x.device)
    ctx.set_output("Out", torch.where(matched[..., None], gathered, fill))
    ctx.set_output("OutWeight", matched[..., None].to(torch.float32))


# ---------------------------------------------------------------------------
# mine_hard_examples
# ---------------------------------------------------------------------------

@register_op("mine_hard_examples")
def mine_hard_examples(ctx):
    """max_negative mining (mine_hard_examples_op.cc): per image the
    negatives (unmatched, and below ``neg_dist_threshold`` where MatchDist
    is given) ranked by classification loss, descending; the first
    neg_pos_ratio·positives of them are kept. NegMask [b, P] int32 marks
    them; UpdatedMatchIndices is -1 there."""
    cls_loss = data_of(ctx.input("ClsLoss"))
    match = data_of(ctx.input("MatchIndices")).to(torch.int32)
    ratio = float(ctx.attr("neg_pos_ratio", 3.0))
    is_neg = match == -1
    if ctx.has_input("MatchDist"):
        is_neg = is_neg & (data_of(ctx.input("MatchDist"))
                           < float(ctx.attr("neg_dist_threshold", 0.5)))
    num_pos = (match >= 0).sum(dim=1, dtype=torch.int32)
    num_neg = torch.minimum((num_pos.to(torch.float32) * ratio)
                            .to(torch.int32),
                            is_neg.sum(dim=1, dtype=torch.int32))
    masked = torch.where(is_neg, cls_loss, torch.full(
        (), float("-inf"), dtype=cls_loss.dtype, device=cls_loss.device))
    order = torch.sort(-masked, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device)
                  .expand_as(order))
    selected = (rank < num_neg[:, None]) & is_neg
    ctx.set_output("NegMask", selected.to(torch.int32))
    ctx.set_output("UpdatedMatchIndices", torch.where(
        selected, torch.full_like(match, -1), match))


# ---------------------------------------------------------------------------
# multiclass_nms
# ---------------------------------------------------------------------------

def _eta_thresholds(nms_threshold, eta, k, device):
    """The NMS threshold after m kept candidates, m = 0..k: multiplied by
    ``eta`` in float32 while above 0.5, as NMSFast adapts it."""
    t = torch.tensor(nms_threshold, dtype=torch.float32)
    tab = [t]
    for _ in range(k):
        if eta < 1.0 and bool(t > 0.5):
            t = t * eta
        tab.append(t)
    return torch.stack(tab).to(device)


def nms_keep(iou_sorted, sscores, score_threshold, nms_threshold, eta, k):
    """NMSFast (multiclass_nms_op.cc:134-172) of every (image, class) pair
    at once over its score-sorted candidates: candidate i is kept where its
    score passes ``score_threshold`` and its IoU with every kept earlier
    candidate is at most the threshold, which each kept candidate
    multiplies by ``eta`` while it is above 0.5. iou_sorted [b, C, k, k]
    and sscores [b, C, k] are in sorted order; returns keep [b, C, k] and
    the number of iterations it took.

    The greedy walk is the one solution of keep_i = cand_i and no kept
    j < i overlaps i beyond the threshold after the kept j < i; this
    iterates that equation from keep = cand to its fixed point, every pair
    and candidate at once. Iteration t settles candidate t for good, so
    keep stops changing after at most k iterations (k + 1 with the one that
    finds it unchanged), and in practice after as many as the longest chain
    of suppressions that undo one another (a staircase of k boxes, each
    overlapping the next, takes all k); each iteration reads one flag back
    to the host."""
    cand = sscores > score_threshold
    lower = torch.ones((k, k), dtype=torch.bool,
                       device=sscores.device).tril(-1)
    adaptive = eta < 1.0
    if adaptive:
        tab = _eta_thresholds(nms_threshold, eta, k, sscores.device)
    else:
        over = (iou_sorted > torch.tensor(nms_threshold,
                                          dtype=torch.float32)) & lower
    keep = cand
    for it in range(1, k + 2):
        if adaptive:
            kept_before = torch.cumsum(keep, dim=-1) - keep.long()
            over = (iou_sorted > tab[kept_before][..., None]) & lower
        new = cand & ~(over & keep[..., None, :]).any(dim=-1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep, it


@register_op("multiclass_nms")
def multiclass_nms(ctx):
    """Per-class NMS and the cross-class keep_top_k (multiclass_nms_op.cc:
    174-250). BBoxes [b, P, 4], Scores [b, C, P]; Out is a LoDArray of
    [b, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), label -1 and
    zeros past each image's count, the counts its lengths. The background
    class never enters NMS."""
    boxes = data_of(ctx.input("BBoxes"))
    scores = data_of(ctx.input("Scores"))
    bg = int(ctx.attr("background_label", 0))
    nms_top_k = int(ctx.attr("nms_top_k"))
    keep_top_k = int(ctx.attr("keep_top_k"))
    b, C, P = scores.shape
    dev = scores.device
    fg = [c for c in range(C) if c != bg] if 0 <= bg < C else list(range(C))
    fg_t = torch.tensor(fg, dtype=torch.long, device=dev)
    fg_scores = scores[:, fg_t]                               # [b, C', P]
    nc = len(fg)
    k = P if nms_top_k < 0 else min(nms_top_k, P)

    sorted_scores, order = torch.sort(fg_scores, dim=-1, descending=True,
                                      stable=True)
    top = order[..., :k]                                      # [b, C', k]
    cand_boxes = torch.gather(
        boxes[:, None].expand(b, nc, P, 4), 2,
        top[..., None].expand(b, nc, k, 4))
    keep_sorted, _ = nms_keep(iou_matrix(cand_boxes, cand_boxes),
                           sorted_scores[..., :k],
                           float(ctx.attr("score_threshold")),
                           float(ctx.attr("nms_threshold", 0.3)),
                           float(ctx.attr("nms_eta", 1.0)), k)
    keep = torch.zeros((b, nc, P), dtype=torch.bool, device=dev)
    keep.scatter_(2, top, keep_sorted)

    flat = torch.where(keep, fg_scores, torch.full(
        (), float("-inf"), dtype=fg_scores.dtype, device=dev)).reshape(b, -1)
    kk = min(keep_top_k if keep_top_k > 0 else C * P, nc * P)
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :kk], top_idx[:, :kk]
    label = fg_t[top_idx // P].to(top_scores.dtype)
    pbox = torch.gather(boxes, 1, (top_idx % P)[..., None].expand(b, kk, 4))
    valid = top_scores > float("-inf")
    zero = torch.zeros((), dtype=top_scores.dtype, device=dev)
    rows = torch.cat([
        torch.where(valid, label, torch.full_like(label, -1.0))[..., None],
        torch.where(valid, top_scores, zero)[..., None],
        torch.where(valid[..., None], pbox, zero)], dim=2)
    ctx.set_output("Out", LoDArray(rows, valid.sum(dim=1,
                                                   dtype=torch.int32)))


# ---------------------------------------------------------------------------
# roi_pool
# ---------------------------------------------------------------------------

@register_op("roi_pool")
def roi_pool(ctx):
    """Max-pool each ROI into pooled_height x pooled_width cells
    (roi_pool_op.cc). ROIs [R, 5] rows (batch index, x1, y1, x2, y2) at
    spatial_scale of the NCHW input; an empty cell is 0."""
    x = data_of(ctx.input("X"))
    rois = data_of(ctx.input("ROIs"))
    ph, pw = int(ctx.attr("pooled_height")), int(ctx.attr("pooled_width"))
    scale = float(ctx.attr("spatial_scale", 1.0))
    _, C, H, W = x.shape
    dev = x.device
    bi = rois[:, 0].to(torch.long)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).to(torch.long)
                      for i in range(1, 5))
    rh = torch.clamp_min(y2 - y1 + 1, 1)
    rw = torch.clamp_min(x2 - x1 + 1, 1)
    img = x[bi]                                               # [R, C, H, W]
    hh = torch.arange(H, device=dev)[None, :]
    ww = torch.arange(W, device=dev)[None, :]
    ninf = torch.full((), float("-inf"), dtype=x.dtype, device=dev)
    cells = []
    for i in range(ph):
        hs = torch.clamp(y1 + (i * rh) // ph, 0, H)[:, None]
        he = torch.clamp(y1 + ((i + 1) * rh + ph - 1) // ph, 0, H)[:, None]
        for j in range(pw):
            ws = torch.clamp(x1 + (j * rw) // pw, 0, W)[:, None]
            we = torch.clamp(x1 + ((j + 1) * rw + pw - 1) // pw, 0,
                             W)[:, None]
            m = ((hh >= hs) & (hh < he))[:, :, None] \
                & ((ww >= ws) & (ww < we))[:, None, :]        # [R, H, W]
            mx = torch.where(m[:, None], img, ninf).amax(dim=(2, 3))
            empty = ~m.flatten(1).any(dim=1)
            cells.append(torch.where(empty[:, None], torch.zeros_like(mx),
                                     mx))
    out = torch.stack(cells, dim=-1).reshape(rois.shape[0], C, ph, pw)
    ctx.set_output("Out", out)
