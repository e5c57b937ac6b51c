"""The detection layers (counterpart of paddle_tpu/fluid/layers/detection.py):
prior_box, iou_similarity, box_coder, bipartite_match, target_assign,
mine_hard_examples, multiclass_nms, detection_output, roi_pool, ssd_loss,
multi_box_head and detection_map. Each appends the same ops, with the same
attrs and names, as its reference counterpart."""

from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from ...ops.detection_ops import expand_aspect_ratios

__all__ = ["prior_box", "iou_similarity", "box_coder", "bipartite_match",
           "target_assign", "mine_hard_examples", "multiclass_nms",
           "detection_output", "roi_pool", "ssd_loss", "multi_box_head",
           "detection_map"]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, steps=None, offset=0.5,
              name=None):
    helper = LayerHelper("prior_box", name=name)
    steps = steps or [0.0, 0.0]
    # anchors are constants wrt the loss (the reference computes them from
    # shapes only); stop_gradient keeps the ssd_loss matching machinery off
    # the gradient path
    boxes = helper.create_tmp_variable("float32", stop_gradient=True)
    var = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(
        "prior_box",
        inputs={"Input": [input.name], "Image": [image.name]},
        outputs={"Boxes": [boxes.name], "Variances": [var.name]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios or [1.0]),
               "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
               "flip": flip, "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, var


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op("iou_similarity",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", name=None):
    """prior_box_var=None means unit variances (the op defaults them)."""
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_tmp_variable(target_box.dtype,
                                     lod_level=target_box.lod_level)
    inputs = {"PriorBox": [prior_box.name],
              "TargetBox": [target_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op("box_coder", inputs=inputs,
                     outputs={"OutputBox": [out.name]},
                     attrs={"code_type": code_type})
    return out


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_tmp_variable("int32", stop_gradient=True)
    match_dist = helper.create_tmp_variable(dist_matrix.dtype,
                                            stop_gradient=True)
    helper.append_op(
        "bipartite_match",
        inputs={"DistMat": [dist_matrix.name]},
        outputs={"ColToRowMatchIndices": [match_indices.name],
                 "ColToRowMatchDist": [match_dist.name]},
        attrs={"match_type": match_type, "dist_threshold": dist_threshold})
    return match_indices, match_dist


def target_assign(input, match_indices, mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_tmp_variable(input.dtype, stop_gradient=True)
    out_weight = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(
        "target_assign",
        inputs={"X": [input.name], "MatchIndices": [match_indices.name]},
        outputs={"Out": [out.name], "OutWeight": [out_weight.name]},
        attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def mine_hard_examples(cls_loss, match_indices, match_dist=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5, name=None):
    helper = LayerHelper("mine_hard_examples", name=name)
    # mined indices are constants wrt the loss (the reference registers no
    # grad for mining either); stop_gradient severs the backward walk so
    # ssd_loss's weight path doesn't demand a mining gradient
    neg_mask = helper.create_tmp_variable("int32", stop_gradient=True)
    updated = helper.create_tmp_variable("int32", stop_gradient=True)
    inputs = {"ClsLoss": [cls_loss.name],
              "MatchIndices": [match_indices.name]}
    if match_dist is not None:
        inputs["MatchDist"] = [match_dist.name]
    helper.append_op(
        "mine_hard_examples", inputs=inputs,
        outputs={"NegMask": [neg_mask.name],
                 "UpdatedMatchIndices": [updated.name]},
        attrs={"neg_pos_ratio": neg_pos_ratio,
               "neg_dist_threshold": neg_dist_threshold})
    return neg_mask, updated


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, nms_eta=1.0, background_label=0,
                   name=None):
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_tmp_variable(bboxes.dtype, lod_level=1)
    helper.append_op(
        "multiclass_nms",
        inputs={"BBoxes": [bboxes.name], "Scores": [scores.name]},
        outputs={"Out": [out.name]},
        attrs={"background_label": background_label,
               "score_threshold": score_threshold,
               "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
               "nms_threshold": nms_threshold, "nms_eta": nms_eta})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     name=None):
    """SSD head postprocess (reference detection.py detection_output):
    decode loc offsets against priors then multiclass NMS. ``loc``
    [b, P, 4], ``scores`` [b, C, P]."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    # decode emits [b, P, 4] boxes already aligned per-prior
    return multiclass_nms(decoded, scores, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold, nms_eta,
                          background_label, name=name)


def roi_pool(input, rois, pooled_height, pooled_width, spatial_scale=1.0,
             name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        "roi_pool",
        inputs={"X": [input.name], "ROIs": [rois.name]},
        outputs={"Out": [out.name]},
        attrs={"pooled_height": pooled_height, "pooled_width": pooled_width,
               "spatial_scale": spatial_scale})
    return out

def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss (reference layers/detection.py:350): match priors
    to ground truth, mine hard negatives, then weight localization
    (smooth-L1 on encoded offsets, positives only) + confidence (softmax CE,
    positives + mined negatives) losses. Composition of the same op chain
    the reference builds: iou_similarity -> bipartite_match ->
    target_assign -> softmax_with_cross_entropy -> mine_hard_examples ->
    box_coder(aligned encode) -> smooth_l1. Returns the per-prior weighted
    loss [batch, num_priors, 1] (reduce it for the training objective);
    ``mining_type`` must be max_negative (hard_example is the reference's
    unimplemented branch too); ``sample_size`` applies to the
    (unimplemented) hard_example mining and is accepted for parity."""
    from .nn import smooth_l1, softmax_with_cross_entropy
    from .tensor import reshape

    if mining_type != "max_negative":
        raise NotImplementedError(
            "ssd_loss: only max_negative mining (the reference's "
            "hard_example branch is unimplemented there as well)")
    helper = LayerHelper("ssd_loss")

    # 1-2. match gt rows to priors
    iou = iou_similarity(gt_box, prior_box)
    match_indices, match_dist = bipartite_match(
        iou, match_type=match_type, dist_threshold=overlap_threshold)

    # 3. confidence targets: matched gt label else background
    tgt_label, pos_weight = target_assign(
        gt_label, match_indices, mismatch_value=background_label)

    # 4. per-prior CE loss (for mining and for the final conf term)
    num_classes = int(confidence.shape[-1])
    conf_2d = reshape(confidence, shape=[-1, num_classes])
    lbl_2d = reshape(tgt_label, shape=[-1, 1])
    conf_loss_2d = softmax_with_cross_entropy(conf_2d, lbl_2d)
    num_priors = int(location.shape[1])   # static prior count
    conf_loss_bp = reshape(conf_loss_2d, shape=[-1, num_priors])

    # 5. hard-negative mining
    neg_mask, _updated = mine_hard_examples(
        conf_loss_bp, match_indices, match_dist=match_dist,
        neg_pos_ratio=neg_pos_ratio, neg_dist_threshold=neg_overlap)

    # 6. localization targets: matched gt boxes, aligned-encoded vs priors;
    # per-prior smooth-L1 over the 4 offsets, positives-only via
    # OutsideWeight
    matched_gt, _ = target_assign(gt_box, match_indices, mismatch_value=0)
    loc_target = box_coder(prior_box, prior_box_var, matched_gt,
                           code_type="encode_center_size")
    loc_target.stop_gradient = True
    loc_2d = reshape(location, shape=[-1, 4])
    tgt_2d = reshape(loc_target, shape=[-1, 4])
    posw_2d = reshape(pos_weight, shape=[-1, 1])
    loc_loss = smooth_l1(loc_2d, tgt_2d, outside_weight=posw_2d)

    # 7. weights: conf over positives + mined negatives; loc over positives
    # (the whole weight path is constant wrt the loss)
    from .tensor import cast
    neg_f = cast(neg_mask, "float32")
    neg_f.stop_gradient = True
    from .nn import elementwise_add, elementwise_mul
    pos_w_bp = reshape(pos_weight, shape=[-1, num_priors])
    pos_w_bp.stop_gradient = True
    conf_w = elementwise_add(pos_w_bp, neg_f)
    conf_w.stop_gradient = True
    conf_term = elementwise_mul(conf_loss_bp, conf_w)

    loc_term = reshape(loc_loss, shape=[-1, num_priors])

    from .tensor import scale
    total = elementwise_add(scale(loc_term, scale=float(loc_loss_weight)),
                            scale(conf_term, scale=float(conf_loss_weight)))
    if normalize:
        # divide by the matched-prior count (min 1), the reference's
        # normalizer
        from .ops import clip, reduce_sum
        clipped = clip(reduce_sum(pos_weight), 1.0, 1e30)
        from .nn import elementwise_div
        total = elementwise_div(total, clipped)
    return reshape(total, shape=[-1, num_priors, 1])


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=None, flip=True, clip=False,
                   kernel_size=1, pad=0, stride=1, name=None):
    """SSD detection head (reference layers/detection.py:568): per feature
    map, a loc conv ([priors*4] filters) + conf conv ([priors*classes]) +
    prior_box, everything flattened and concatenated across maps. Returns
    (mbox_locs [b, P, 4], mbox_confs [b, P, C], boxes [P, 4],
    variances [P, 4])."""
    from .nn import conv2d
    from .tensor import concat, reshape, transpose

    variance = list(variance or [0.1, 0.1, 0.2, 0.2])
    n_maps = len(inputs)
    if min_sizes is None:
        # the reference's ratio schedule (detection.py:688-699)
        assert min_ratio is not None and max_ratio is not None
        min_sizes, max_sizes = [], []
        if n_maps > 2:
            step = int(np.floor((max_ratio - min_ratio) / (n_maps - 2)))
            for r in range(min_ratio, max_ratio + 1, step):
                min_sizes.append(base_size * r / 100.0)
                max_sizes.append(base_size * (r + step) / 100.0)
            min_sizes = [base_size * 0.1] + min_sizes
            max_sizes = [base_size * 0.2] + max_sizes
        else:
            min_sizes = [base_size * (min_ratio / 100.0)] * n_maps
            max_sizes = [base_size * (max_ratio / 100.0)] * n_maps

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        mn = min_sizes[i]
        mx = max_sizes[i] if max_sizes else None
        ars = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                             (list, tuple)) \
            else [aspect_ratios[i]]
        step_i = steps[i] if steps else [
            step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0]
        boxes, var = prior_box(
            feat, image, min_sizes=[mn],
            max_sizes=[mx] if mx else None, aspect_ratios=ars,
            variance=variance, flip=flip, clip=clip,
            steps=list(step_i) if isinstance(step_i, (list, tuple))
            else [step_i, step_i], offset=offset)
        # priors per cell from the op's own expansion (flip deduplicated),
        # so the conv channels always match the priors the op emits
        expanded = expand_aspect_ratios([float(a) for a in ars], flip)
        num_priors = 1 + (1 if mx else 0) + sum(
            1 for a in expanded if abs(a - 1.0) > 1e-6)

        loc = conv2d(input=feat, num_filters=num_priors * 4,
                     filter_size=kernel_size, padding=pad, stride=stride,
                     act=None)
        conf = conv2d(input=feat, num_filters=num_priors * num_classes,
                      filter_size=kernel_size, padding=pad, stride=stride,
                      act=None)
        # static per-map prior count keeps downstream shapes (ssd_loss
        # num_priors) statically known even with a dynamic batch dim
        fh, fw = int(feat.shape[2]), int(feat.shape[3])
        p_i = fh * fw * num_priors
        locs.append(reshape(transpose(loc, perm=[0, 2, 3, 1]),
                            shape=[0, p_i, 4]))
        confs.append(reshape(transpose(conf, perm=[0, 2, 3, 1]),
                             shape=[0, p_i, num_classes]))
        boxes_all.append(reshape(boxes, shape=[-1, 4]))
        vars_all.append(reshape(var, shape=[-1, 4]))

    mbox_locs = concat(locs, axis=1)
    mbox_confs = concat(confs, axis=1)
    box = concat(boxes_all, axis=0)
    var = concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, box, var


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """detection_map op layer (reference layers/detection.py:157): mAP of a
    batch of detections vs labeled ground truth (the stateful cross-batch
    accumulation lives in fluid.evaluator.DetectionMAP)."""
    helper = LayerHelper("detection_map")
    map_out = helper.create_tmp_variable("float32")
    inputs = {"DetectRes": [detect_res.name], "Label": [label.name]}
    if has_state is not None:
        inputs["HasState"] = [has_state.name]
    if input_states is not None:
        inputs["PosCount"] = [input_states[0].name]
        inputs["TruePos"] = [input_states[1].name]
        inputs["FalsePos"] = [input_states[2].name]
    if out_states is not None:
        accum = {"AccumPosCount": [out_states[0].name],
                 "AccumTruePos": [out_states[1].name],
                 "AccumFalsePos": [out_states[2].name]}
    else:
        accum = {"AccumPosCount": [
                     helper.create_tmp_variable("int32").name],
                 "AccumTruePos": [
                     helper.create_tmp_variable("float32").name],
                 "AccumFalsePos": [
                     helper.create_tmp_variable("float32").name]}
    helper.append_op(
        "detection_map", inputs=inputs,
        outputs={"MAP": [map_out.name], **accum},
        attrs={"class_num": int(class_num),
               "background_label": int(background_label),
               "overlap_threshold": float(overlap_threshold),
               "evaluate_difficult": bool(evaluate_difficult),
               "ap_type": ap_version})
    return map_out
