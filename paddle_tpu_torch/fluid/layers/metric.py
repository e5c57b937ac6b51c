"""Metric layers (counterpart of paddle_tpu/fluid/layers/metric.py):
``auc`` (reference :12), ``precision_recall`` (:30) and ``chunk_eval``
(:50). ``accuracy`` is in ``nn.py``, as the reference's."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["auc", "precision_recall", "chunk_eval"]


def auc(input, label, curve="ROC", num_thresholds=200, name=None):
    """Batch AUC of input[:, 0]: (auc, [tp, fn, tn, fp] stat vectors that
    an evaluator accumulates)."""
    helper = LayerHelper("auc", name=name)
    out = helper.create_tmp_variable("float32", shape=())
    stats = [helper.create_tmp_variable("float32", shape=(num_thresholds,))
             for _ in range(4)]
    helper.append_op(
        "auc", inputs={"Out": [input.name], "Label": [label.name]},
        outputs={"AUC": [out.name], "TPOut": [stats[0].name],
                 "FNOut": [stats[1].name], "TNOut": [stats[2].name],
                 "FPOut": [stats[3].name]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return out, stats


def precision_recall(indices, labels, class_number, weights=None,
                     states_info=None, name=None):
    """(batch metrics [6], running metrics [6], running states [C, 4])."""
    helper = LayerHelper("precision_recall", name=name)
    batch = helper.create_tmp_variable("float32", shape=(6,))
    accum = helper.create_tmp_variable("float32", shape=(6,))
    states = helper.create_tmp_variable("float32", shape=(class_number, 4))
    inputs = {"Indices": [indices.name], "Labels": [labels.name]}
    if weights is not None:
        inputs["Weights"] = [weights.name]
    if states_info is not None:
        inputs["StatesInfo"] = [states_info.name]
    helper.append_op(
        "precision_recall", inputs=inputs,
        outputs={"BatchMetrics": [batch.name], "AccumMetrics": [accum.name],
                 "AccumStatesInfo": [states.name]},
        attrs={"class_number": class_number})
    return batch, accum, states


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, name=None):
    """Chunking precision, recall and F1 and the three int64 chunk counts:
    (precision, recall, f1, n_infer, n_label, n_correct). The op reads its
    inputs to the host."""
    helper = LayerHelper("chunk_eval", name=name)
    outs = [helper.create_tmp_variable(dtype, shape=(1,))
            for dtype in ("float32",) * 3 + ("int64",) * 3]
    slots = ("Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks")
    helper.append_op(
        "chunk_eval",
        inputs={"Inference": [input.name], "Label": [label.name]},
        outputs={s: [v.name] for s, v in zip(slots, outs)},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    return tuple(outs)
