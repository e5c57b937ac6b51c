"""``paddle.v2.evaluator`` — evaluator spellings of the v2 generation.

Reference: python/paddle/v2/evaluator.py (auto-converts every
``*_evaluator`` of python/paddle/trainer_config_helpers/evaluators.py:18-35
to a v2 name with the suffix dropped). In the reference these attach
evaluator configs to the topology and the GradientMachine accumulates them;
here each evaluator appends the corresponding metric ops to the program
being built and returns a LayerOutput, so callers fetch it per batch
(``SGD.train`` feeds fetched metrics into the event stream) or wrap it with
``fluid.evaluator`` for cross-batch accumulation.
"""

from __future__ import annotations

from .config_helpers import LayerOutput, _unwrap

__all__ = ["classification_error", "auc", "pnpair", "precision_recall",
           "ctc_error", "chunk", "sum", "column_sum", "value_printer",
           "maxid_printer", "detection_map"]


def classification_error(input, label, name=None, top_k=1, **kw):
    """evaluators.py classification_error_evaluator: error rate = 1 - top-k
    accuracy (reference computes error; fluid's accuracy op computes the
    complement)."""
    import paddle_tpu_torch.fluid as fluid
    acc = fluid.layers.accuracy(input=_unwrap(input),
                                label=_unwrap(label, "label"), k=top_k)
    one = fluid.layers.fill_constant(shape=[1], dtype="float32", value=1.0)
    err = fluid.layers.elementwise_sub(one, acc)
    return LayerOutput(err, size=1, name=name)


def auc(input, label, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.auc(input=_unwrap(input),
                           label=_unwrap(label, "label"))
    var = out[0] if isinstance(out, (tuple, list)) else out
    return LayerOutput(var, size=1, name=name)


def pnpair(input, label, query_id, weight=None, name=None, **kw):
    """positive_negative_pair over (score, label, query) triples."""
    from ..fluid.layer_helper import LayerHelper
    helper = LayerHelper("positive_negative_pair", name=name)
    outs = {s: helper.create_tmp_variable("float32")
            for s in ("PositivePair", "NegativePair", "NeutralPair")}
    inputs = {"Score": [_unwrap(input).name],
              "Label": [_unwrap(label, "label").name],
              "QueryID": [_unwrap(query_id, "label").name]}
    if weight is not None:
        inputs["Weight"] = [_unwrap(weight).name]
    helper.append_op("positive_negative_pair", inputs=inputs,
                     outputs={k: [v.name] for k, v in outs.items()})
    return LayerOutput(outs["PositivePair"], size=1, name=name)


def precision_recall(input, label, positive_label=None, weight=None,
                     name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    inp = _unwrap(input)
    maxids = fluid.layers.topk(inp, k=1)[1]
    out = fluid.layers.precision_recall(
        indices=maxids, labels=_unwrap(label, "label"),
        class_number=input.size)
    var = out[0] if isinstance(out, (tuple, list)) else out
    return LayerOutput(var, size=None, name=name)


def ctc_error(input, label, name=None, **kw):
    """evaluators.py ctc_error_evaluator: normalized edit distance between
    the decoded prediction and the label sequence."""
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.edit_distance(input=_unwrap(input, "seq_ids"),
                                     label=_unwrap(label, "seq_ids"),
                                     normalized=True)
    var = out[0] if isinstance(out, (tuple, list)) else out
    return LayerOutput(var, size=1, name=name)


def chunk(input, label, chunk_scheme, num_chunk_types, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.chunk_eval(input=_unwrap(input, "seq_ids"),
                                  label=_unwrap(label, "seq_ids"),
                                  chunk_scheme=chunk_scheme,
                                  num_chunk_types=num_chunk_types)
    var = out[0] if isinstance(out, (tuple, list)) else out
    return LayerOutput(var, size=1, name=name)


def sum(input, name=None, **kw):  # noqa: A001 (reference name)
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.reduce_sum(_unwrap(input))
    return LayerOutput(out, size=1, name=name)


def column_sum(input, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.reduce_sum(_unwrap(input), dim=0)
    return LayerOutput(out, size=getattr(input, "size", None), name=name)


def value_printer(input, name=None, **kw):
    """evaluators.py value_printer_evaluator -> the Print debug op."""
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.Print(_unwrap(input),
                             message=name or "value_printer")
    return LayerOutput(out, size=getattr(input, "size", None), name=name)


def maxid_printer(input, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    maxids = fluid.layers.topk(_unwrap(input), k=1)[1]
    out = fluid.layers.Print(maxids, message=name or "maxid_printer")
    return LayerOutput(out, size=1, name=name)


def detection_map(overlap_threshold=0.5, name=None, **kw):
    """detection_map_evaluator — served by the stateful fluid DetectionMAP
    evaluator (fluid/evaluator.py): host-side accumulation over
    multiclass_nms outputs, ``update()`` per batch + ``eval()``."""
    from ..fluid import evaluator as fe
    return fe.DetectionMAP(overlap_threshold=overlap_threshold, name=name)
