"""Declared slot-arity catalogue for the verifier (PTL002; counterpart of
paddle_tpu/fluid/analysis/slots.py, the same 39 specs).

The reference's OpProto declares every op's input/output slots in C++ and
op_registry.h rejects an OpDesc whose slots disagree at construction time.
Here the specs are registered post-hoc onto the OpInfo records
(core.registry.register_slots) for the op types that transform passes
create, rewire, or strip — the op set where a pass bug actually lands.
Ops without a spec are not arity-checked (the shadow infer_shape pass
still catches most slot damage for them); add a spec here when an op
joins a transform's rewrite surface. ``register_all`` skips an op type
this package does not register; every one of the 39 is registered, so
all 39 specs are installed. The op modules register before this one runs
(``fluid/__init__`` imports ``ops`` first), so ``reshape``'s spec is
installed.

Markers: "1" exactly one var, "?" zero or one, "+" one or more, "*" any.
"""

from __future__ import annotations

from ...core.registry import has_op, register_slots

_SPECS = {
    # ---- the conv/bn/activation chain the fusion pass rewrites ----
    "conv2d": ({"Input": "1", "Filter": "1"}, {"Output": "1"}),
    "batch_norm": (
        {"X": "1", "Scale": "1", "Bias": "1", "Mean": "1", "Variance": "1"},
        {"Y": "1", "MeanOut": "?", "VarianceOut": "?", "SavedMean": "?",
         "SavedVariance": "?"}),
    "fused_conv2d_bn": (
        {"Input": "1", "Filter": "1", "Scale": "1", "Bias": "1",
         "Mean": "1", "Variance": "1"},
        {"Output": "1", "MeanOut": "?", "VarianceOut": "?",
         "SavedMean": "?", "SavedVariance": "?"}),
    "relu": ({"X": "1"}, {"Out": "1"}),
    "sigmoid": ({"X": "1"}, {"Out": "1"}),
    "tanh": ({"X": "1"}, {"Out": "1"}),
    "dropout": ({"X": "1"}, {"Out": "1", "Mask": "?"}),

    # ---- the dense math backbone of every book model ----
    "mul": ({"X": "1", "Y": "1"}, {"Out": "1"}),
    "matmul": ({"X": "1", "Y": "1"}, {"Out": "1"}),
    "elementwise_add": ({"X": "1", "Y": "1"}, {"Out": "1"}),
    "elementwise_sub": ({"X": "1", "Y": "1"}, {"Out": "1"}),
    "elementwise_mul": ({"X": "1", "Y": "1"}, {"Out": "1"}),
    "elementwise_div": ({"X": "1", "Y": "1"}, {"Out": "1"}),
    "softmax": ({"X": "1"}, {"Out": "1"}),
    "cross_entropy": ({"X": "1", "Label": "1"}, {"Y": "1"}),
    "softmax_with_cross_entropy": (
        {"Logits": "1", "Label": "1"}, {"Softmax": "?", "Loss": "1"}),
    "mean": ({"X": "1"}, {"Out": "1"}),
    "sum": ({"X": "+"}, {"Out": "1"}),
    "concat": ({"X": "+"}, {"Out": "1"}),
    "lookup_table": ({"W": "1", "Ids": "1"}, {"Out": "1"}),
    "top_k": ({"X": "1"}, {"Out": "1", "Indices": "?"}),
    "accuracy": ({"Out": "1", "Indices": "1", "Label": "1"},
                 {"Accuracy": "1", "Correct": "?", "Total": "?"}),

    # ---- backward scaffolding appended by append_backward ----
    "fill_constant": ({}, {"Out": "1"}),
    "fill_zeros_like": ({"X": "1"}, {"Out": "1"}),
    "assign": ({"X": "1"}, {"Out": "1"}),
    "scale": ({"X": "1"}, {"Out": "1"}),
    "cast": ({"X": "1"}, {"Out": "1"}),
    "reshape": ({"X": "1"}, {"Out": "1"}),

    # ---- optimizer ops the DistributeTranspiler lifts server-side ----
    "sgd": ({"Param": "1", "Grad": "1", "LearningRate": "1"},
            {"ParamOut": "1"}),
    "momentum": ({"Param": "1", "Grad": "1", "Velocity": "1",
                  "LearningRate": "1"},
                 {"ParamOut": "1", "VelocityOut": "1"}),
    "adam": ({"Param": "1", "Grad": "1", "Moment1": "1", "Moment2": "1",
              "Beta1Pow": "1", "Beta2Pow": "1", "LearningRate": "1"},
             {"ParamOut": "1", "Moment1Out": "1", "Moment2Out": "1"}),
    "fused_sgd": ({"Params": "+", "Grads": "+", "LearningRate": "1"},
                  {"ParamsOut": "+"}),
    "fused_momentum": ({"Params": "+", "Grads": "+", "Velocities": "+",
                        "LearningRate": "1"},
                       {"ParamsOut": "+", "VelocitiesOut": "+"}),
    "fused_adam": ({"Params": "+", "Grads": "+", "Moment1s": "+",
                    "Moment2s": "+", "Beta1Pow": "1", "Beta2Pow": "1",
                    "LearningRate": "1"},
                   {"ParamsOut": "+", "Moment1sOut": "+",
                    "Moment2sOut": "+"}),

    # ---- the attention sites the GenerationEngine rewrites per phase ----
    "causal_self_attention": ({"Q": "1", "K": "1", "V": "1"}, {"Out": "1"}),
    "prefill_attention": (
        {"Q": "1", "K": "1", "V": "1", "KCache": "1", "VCache": "1",
         "SlotMapping": "1"},
        {"Out": "1", "KCacheOut": "1", "VCacheOut": "1"}),
    "chunked_prefill_attention": (
        {"Q": "1", "K": "1", "V": "1", "KCache": "1", "VCache": "1",
         "SlotMapping": "1", "BlockTables": "1", "ChunkStart": "1"},
        {"Out": "1", "KCacheOut": "1", "VCacheOut": "1"}),
    "paged_attention": (
        {"Q": "1", "K": "1", "V": "1", "KCache": "1", "VCache": "1",
         "SlotMapping": "1", "BlockTables": "1", "ContextLens": "1"},
        {"Out": "1", "KCacheOut": "1", "VCacheOut": "1"}),

    # ---- eager-interpreter memory pass scaffolding ----
    "delete_var": ({"X": "+"}, {}),
}


def register_all():
    """Idempotently install the catalogue onto the op registry."""
    for op_type, (ins, outs) in _SPECS.items():
        if has_op(op_type):
            register_slots(op_type, inputs=ins, outputs=outs)


register_all()
