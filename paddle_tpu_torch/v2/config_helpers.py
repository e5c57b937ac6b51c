"""trainer_config_helpers — the legacy v2 layer-config DSL (counterpart of
paddle_tpu/v2/config_helpers.py).

Reference: python/paddle/trainer_config_helpers/layers.py (the layer DSL),
networks.py (img_conv_group, simple_lstm), config_parser.py (the Python to
ModelConfig compiler, with its shape inference: the square-image sqrt rule
and the caffe/ceil output-size modes), and activations.py, poolings.py,
attrs.py, optimizers.py beside them.

Every ``*_layer`` call lowers at once onto the port's fluid Program builder
(paddle_tpu_torch.fluid.layers), op for op, name for name, as the JAX
package's lowers onto its own, so a v2 config script is a fluid topology
that the port's Executor runs. Sequence layers carry LoD metadata; image
layers carry (C, H, W) metadata with the reference's shape rules
(config_parser.py cnn_output_size: caffe mode for conv, ceil mode for
pooling; height = width = sqrt(size / channels) when unspecified).

Data layers are lazy: the reference's data_layer declares only a size;
whether it is a float image, an integer label or a token sequence is
decided by the data provider. Here the first consumer materializes the
variable with the right dtype and LoD level (conv: float image, cost
label: int64, embedding: int64 sequence), the same decisions as the JAX
package's, so both name, type and shape every variable alike.

Run a config with ``parse_config(source)`` (the ``paddle train
--config=`` analog) and feed the result to ``paddle_tpu_torch.v2.SGD``.
"""

from __future__ import annotations

import math
import re

__all__ = [
    # plumbing
    "settings", "get_config_arg", "set_config_args", "outputs",
    "define_py_data_sources2", "get_topology", "parse_config", "Topology",
    # activations
    "ReluActivation", "LinearActivation", "SoftmaxActivation",
    "SigmoidActivation", "TanhActivation", "IdentityActivation",
    # poolings
    "MaxPooling", "AvgPooling", "SumPooling",
    # attrs
    "ExtraAttr", "ExtraLayerAttribute", "ParamAttr", "ParameterAttribute",
    # optimizers / regularizers
    "MomentumOptimizer", "AdamOptimizer", "AdamaxOptimizer",
    "RMSPropOptimizer", "AdaGradOptimizer", "DecayedAdaGradOptimizer",
    "AdaDeltaOptimizer", "L2Regularization", "L1Regularization",
    # layers
    "data_layer", "fc_layer", "img_conv_layer", "img_pool_layer",
    "img_cmrnorm_layer", "batch_norm_layer", "addto_layer", "concat_layer",
    "dropout_layer", "embedding_layer", "lstmemory", "simple_lstm",
    "grumemory", "simple_gru", "last_seq", "first_seq", "pooling_layer",
    "cross_entropy", "classification_cost", "regression_cost",
    "img_conv_group", "conv_projection", "LayerOutput",
]


# ---------------------------------------------------------------------------
# global config state (the reference keeps this in config_parser globals)
# ---------------------------------------------------------------------------

_SETTINGS: dict = {}
_CONFIG_ARGS: dict = {}
_OUTPUTS: list = []
_DATA_LAYERS: list = []
_DATA_SOURCES: dict = {}
_SEQUENCE_HINTS: set = set()


def _reset_config():
    _SETTINGS.clear()
    _CONFIG_ARGS.clear()
    del _OUTPUTS[:]
    del _DATA_LAYERS[:]
    _DATA_SOURCES.clear()
    _SEQUENCE_HINTS.clear()


def parse_config_args(s):
    """'k1=v1,k2=v2' -> dict, whitespace-tolerant (the --config_args CLI
    format shared by the trainer CLI and the utils tools)."""
    out = {}
    for kv in (s or "").split(","):
        if "=" in kv:
            k, _, v = kv.partition("=")
            out[k.strip()] = v.strip()
    return out


def set_config_args(**kwargs):
    """Provide the values get_config_arg reads (the reference passes them on
    the paddle_trainer command line: --config_args=batch_size=64,...)."""
    _CONFIG_ARGS.update(kwargs)


def get_config_arg(name, type_, default=None):
    v = _CONFIG_ARGS.get(name, default)
    if v is None:
        return None
    if type_ is bool and isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    return type_(v)


def settings(batch_size=None, learning_rate=1e-3, learning_method=None,
             regularization=None, gradient_clipping_threshold=None, **kw):
    _SETTINGS.update(dict(
        batch_size=batch_size, learning_rate=learning_rate,
        learning_method=learning_method, regularization=regularization,
        gradient_clipping_threshold=gradient_clipping_threshold, **kw))


def define_py_data_sources2(train_list, test_list, module=None, obj=None,
                            args=None):
    """Recorded for introspection only: the v2 trainer contract feeds
    readers directly (reference PyDataProvider2 pulled batches through an
    embedded interpreter; here the reader decorators own that job)."""
    _DATA_SOURCES.update(dict(train_list=train_list, test_list=test_list,
                              module=module, obj=obj, args=args or {}))


def outputs(*layers):
    del _OUTPUTS[:]
    _OUTPUTS.extend(layers)


# ---------------------------------------------------------------------------
# activations / poolings / attrs / optimizers
# ---------------------------------------------------------------------------

class _Activation:
    act = None

    def __repr__(self):
        return f"{type(self).__name__}()"


class ReluActivation(_Activation):
    act = "relu"


class LinearActivation(_Activation):
    act = None


IdentityActivation = LinearActivation


class SoftmaxActivation(_Activation):
    act = "softmax"


class SigmoidActivation(_Activation):
    act = "sigmoid"


class TanhActivation(_Activation):
    act = "tanh"


def _act_str(act):
    if act is None:
        return None
    if isinstance(act, str):
        return act
    return act.act


class _Pooling:
    pool_type = "max"


class MaxPooling(_Pooling):
    pool_type = "max"

    def __init__(self, output_max_index=False):
        # output_max_index is accepted for config parity (reference
        # poolings.py); index emission is served by max_pool*_with_index
        self.output_max_index = output_max_index


class AvgPooling(_Pooling):
    pool_type = "avg"


class SumPooling(_Pooling):
    pool_type = "sum"


# cudnn pooling spellings (reference poolings.py CudnnMaxPooling /
# CudnnAvgPooling: kernel-choice hints; one pool2d op here)
class CudnnMaxPooling(MaxPooling):
    pass


class CudnnAvgPooling(AvgPooling):
    pass


class ExtraLayerAttribute:
    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None):
        self.drop_rate = drop_rate
        self.error_clipping_threshold = error_clipping_threshold
        self.device = device


ExtraAttr = ExtraLayerAttribute


class ParameterAttribute:
    """Maps the commonly used subset onto fluid.ParamAttr (reference
    attrs.py ParameterAttribute has ~15 knobs tied to the legacy updater)."""

    def __init__(self, name=None, initial_std=None, initial_mean=None,
                 learning_rate=None, l1_rate=None, l2_rate=None,
                 is_static=False, **kw):
        self.name = name
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.learning_rate = learning_rate
        self.l2_rate = l2_rate
        self.is_static = is_static

    def to_fluid(self):
        from ..fluid.param_attr import ParamAttr as FluidParamAttr
        from ..fluid.initializer import Normal
        init = None
        if self.initial_std is not None or self.initial_mean is not None:
            init = Normal(loc=self.initial_mean or 0.0,
                          scale=self.initial_std
                          if self.initial_std is not None else 0.01)
        return FluidParamAttr(name=self.name, initializer=init,
                              learning_rate=self.learning_rate
                              if self.learning_rate is not None else 1.0,
                              trainable=not self.is_static)


ParamAttr = ParameterAttribute


def _fluid_param_attr(attr):
    if attr is None or attr is True:
        return None
    if isinstance(attr, ParameterAttribute):
        return attr.to_fluid()
    return attr


class _OptimizerSpec:
    fluid_cls = None
    kwargs: dict = {}

    def create(self, learning_rate, regularization=None):
        import paddle_tpu_torch.fluid as fluid
        cls = getattr(fluid.optimizer, self.fluid_cls)
        return cls(learning_rate=learning_rate,
                   regularization=regularization, **self.kwargs)


class MomentumOptimizer(_OptimizerSpec):
    fluid_cls = "Momentum"

    def __init__(self, momentum=0.9, sparse=False):
        self.kwargs = {"momentum": momentum}


class AdamOptimizer(_OptimizerSpec):
    fluid_cls = "Adam"

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.kwargs = {"beta1": beta1, "beta2": beta2, "epsilon": epsilon}


class AdamaxOptimizer(_OptimizerSpec):
    fluid_cls = "Adamax"

    def __init__(self, beta1=0.9, beta2=0.999):
        self.kwargs = {"beta1": beta1, "beta2": beta2}


class RMSPropOptimizer(_OptimizerSpec):
    fluid_cls = "RMSProp"

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.kwargs = {"rho": rho, "epsilon": epsilon}


class AdaGradOptimizer(_OptimizerSpec):
    fluid_cls = "Adagrad"

    def __init__(self, epsilon=1e-6):
        self.kwargs = {"epsilon": epsilon}


class DecayedAdaGradOptimizer(_OptimizerSpec):
    fluid_cls = "DecayedAdagrad"

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.kwargs = {"decay": rho, "epsilon": epsilon}


class AdaDeltaOptimizer(_OptimizerSpec):
    fluid_cls = "Adadelta"

    def __init__(self, rho=0.95, epsilon=1e-6):
        self.kwargs = {"rho": rho, "epsilon": epsilon}


class L2Regularization:
    def __init__(self, rate):
        self.rate = rate

    def to_fluid(self):
        from ..fluid.regularizer import L2Decay
        return L2Decay(self.rate)


class L1Regularization:
    def __init__(self, rate):
        self.rate = rate

    def to_fluid(self):
        from ..fluid.regularizer import L1Decay
        return L1Decay(self.rate)


# ---------------------------------------------------------------------------
# LayerOutput
# ---------------------------------------------------------------------------

class LayerOutput:
    """A DSL node: the lowered fluid Variable plus v2 metadata. Data layers
    defer materialization to their first consumer (see module docstring)."""

    def __init__(self, var=None, size=None, hwc=None, is_seq=False,
                 name=None, data_size=None):
        self._var = var
        self.size = size
        self.hwc = hwc            # (channels, height, width) when image-like
        self.is_seq = is_seq
        self.name = name
        self._data_size = data_size   # pending data layer: declared size

    # ---- lazy data-layer materialization ----
    @property
    def is_pending(self):
        return self._var is None

    def materialize(self, kind="dense"):
        """kind: dense [-1, size] float | label [-1, 1] int64 |
        seq_ids [-1, 1] int64 lod 1 | seq_dense [-1, size] float lod 1.
        A sequence hint (parse_config(sequence_inputs=...)) upgrades the
        dense/label guesses — the reference learns sequence-ness from the
        data provider at runtime, which an eager lowering cannot see."""
        if self._var is not None:
            return self._var
        if self.name in _SEQUENCE_HINTS:
            kind = {"dense": "seq_dense", "label": "seq_ids"}.get(kind, kind)
        import paddle_tpu_torch.fluid as fluid
        if kind == "label":
            self._var = fluid.layers.data(self.name, shape=[1],
                                          dtype="int64")
        elif kind == "seq_ids":
            self._var = fluid.layers.data(self.name, shape=[1],
                                          dtype="int64", lod_level=1)
            self.is_seq = True
        elif kind == "seq_dense":
            self._var = fluid.layers.data(self.name, shape=[self._data_size],
                                          lod_level=1)
            self.is_seq = True
        else:
            self._var = fluid.layers.data(self.name,
                                          shape=[self._data_size])
        self.size = self._data_size
        return self._var

    @property
    def var(self):
        return self.materialize()

    def __repr__(self):
        return (f"LayerOutput(name={self.name!r}, size={self.size}, "
                f"hwc={self.hwc}, seq={self.is_seq}, "
                f"pending={self.is_pending})")


def _unwrap(v, kind="dense"):
    if isinstance(v, LayerOutput):
        return v.materialize(kind) if v.is_pending else v.var
    return v


def _img_meta(input, num_channels=None):
    """(C, H, W) of a layer input, inferring square images from flat sizes
    (config_parser.py: img_size = sqrt(size / channels) when not given)."""
    if isinstance(input, LayerOutput) and input.hwc is not None:
        return input.hwc
    size = (input.size or input._data_size) \
        if isinstance(input, LayerOutput) else None
    if num_channels is None:
        raise ValueError(
            "img layer needs num_channels when its input carries no image "
            "metadata (reference config_parser infers only from a prior "
            "image layer)")
    if size is None:
        raise ValueError("cannot infer image height/width: input size "
                         "unknown")
    pixels = size // num_channels
    # the reference's get_img_size rule (config_parser.py:1210-1215):
    # width = floor(sqrt(pixels)), height = pixels // width, ASSERTING
    # width * height == pixels — squares pass, 12 -> 4x3 passes, a typo'd
    # size like 783 still errors at config time
    w = int(math.isqrt(pixels))
    h = pixels // max(w, 1)
    if w <= 0 or w * h != pixels or pixels * num_channels != size:
        raise ValueError(
            f"input size {size} does not factor into H x W x "
            f"{num_channels} channels (reference get_img_size rule)")
    return (num_channels, h, w)


def _as_image_var(input, num_channels=None):
    """Fluid var reshaped to [-1, C, H, W] + its (C,H,W)."""
    import paddle_tpu_torch.fluid as fluid
    c, h, w = _img_meta(input, num_channels)
    var = _unwrap(input)
    if var.shape is not None and len(var.shape) == 2:
        var = fluid.layers.reshape(var, [-1, c, h, w])
    return var, (c, h, w)


def _conv_out(sz, f, p, s, caffe_mode=True):
    """config_parser.py cnn_output_size: caffe mode floors, legacy pooling
    mode ceils."""
    if caffe_mode:
        return (sz - f + 2 * p) // s + 1
    return int(math.ceil((sz - f + 2 * p) / s)) + 1


def _apply_drop(out_var, layer_attr):
    import paddle_tpu_torch.fluid as fluid
    if isinstance(layer_attr, ExtraLayerAttribute) and layer_attr.drop_rate:
        return fluid.layers.dropout(out_var, layer_attr.drop_rate)
    return out_var


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def data_layer(name, size, height=None, width=None, **kw):
    out = LayerOutput(name=name, data_size=size)
    if height and width:
        c = size // (height * width)
        out.hwc = (c, height, width)
    _DATA_LAYERS.append(out)
    return out


def fc_layer(input, size, act=None, param_attr=None, bias_attr=True,
             layer_attr=None, name=None):
    import paddle_tpu_torch.fluid as fluid
    inputs = input if isinstance(input, (list, tuple)) else [input]
    vars_ = [_unwrap(i) for i in inputs]
    out = fluid.layers.fc(vars_ if len(vars_) > 1 else vars_[0], size,
                          act=_act_str(act),
                          param_attr=_fluid_param_attr(param_attr),
                          bias_attr=None if bias_attr is True else bias_attr,
                          name=name)
    out = _apply_drop(out, layer_attr)
    is_seq = any(isinstance(i, LayerOutput) and i.is_seq for i in inputs)
    return LayerOutput(out, size=size, name=name, is_seq=is_seq)


def img_conv_layer(input, filter_size, num_filters, name=None,
                   num_channels=None, stride=1, padding=0, groups=1,
                   act=None, bias_attr=True, param_attr=None,
                   layer_attr=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    var, (c, h, w) = _as_image_var(input, num_channels)
    out = fluid.layers.conv2d(
        var, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=padding, groups=groups, act=_act_str(act),
        bias_attr=None if bias_attr is True else bias_attr,
        param_attr=_fluid_param_attr(param_attr), name=name)
    oh = _conv_out(h, filter_size, padding, stride)
    ow = _conv_out(w, filter_size, padding, stride)
    out = _apply_drop(out, layer_attr)
    return LayerOutput(out, size=num_filters * oh * ow,
                       hwc=(num_filters, oh, ow), name=name)


def img_pool_layer(input, pool_size, name=None, num_channels=None, stride=1,
                   padding=0, pool_type=None, layer_attr=None,
                   pool_size_y=None, stride_y=None, padding_y=None, **kw):
    """_y variants give asymmetric windows (reference img_pool_layer:
    pool_size is the x/width extent, *_y the height)."""
    import paddle_tpu_torch.fluid as fluid
    var, (c, h, w) = _as_image_var(input, num_channels)
    ptype = (pool_type or MaxPooling()).pool_type
    ph, pw = (pool_size_y or pool_size), pool_size
    sh, sw = (stride_y or stride), stride
    pdh, pdw = (padding if padding_y is None else padding_y), padding
    out = fluid.layers.pool2d(var, pool_size=[ph, pw], pool_type=ptype,
                              pool_stride=[sh, sw], pool_padding=[pdh, pdw],
                              ceil_mode=True)
    # legacy pooling uses the ceil output size (config_parser.py
    # cnn_output_size with caffe_mode=False)
    oh = _conv_out(h, ph, pdh, sh, caffe_mode=False)
    ow = _conv_out(w, pw, pdw, sw, caffe_mode=False)
    return LayerOutput(out, size=c * oh * ow, hwc=(c, oh, ow), name=name)


def img_cmrnorm_layer(input, size=5, scale=0.0001, power=0.75, name=None,
                      num_channels=None, **kw):
    """Cross-map response normalization (reference layers.py
    img_cmrnorm_layer -> config_parser divides scale by size before the
    kernel, gserver NormProjectionLayer)."""
    import paddle_tpu_torch.fluid as fluid
    var, hwc = _as_image_var(input, num_channels)
    out = fluid.layers.lrn(var, n=size, k=1.0, alpha=scale / size,
                           beta=power)
    lo = LayerOutput(out, size=hwc[0] * hwc[1] * hwc[2], hwc=hwc, name=name)
    return lo


def batch_norm_layer(input, act=None, name=None, num_channels=None,
                     use_global_stats=None, moving_average_fraction=0.9,
                     bias_attr=True, param_attr=None, layer_attr=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    var, hwc = _as_image_var(input, num_channels)
    out = fluid.layers.batch_norm(
        var, act=_act_str(act), is_test=bool(use_global_stats),
        momentum=moving_average_fraction,
        param_attr=_fluid_param_attr(param_attr))
    return LayerOutput(out, size=hwc[0] * hwc[1] * hwc[2], hwc=hwc,
                       name=name)


def addto_layer(input, act=None, name=None, bias_attr=False, **kw):
    import paddle_tpu_torch.fluid as fluid
    inputs = input if isinstance(input, (list, tuple)) else [input]
    acc = _unwrap(inputs[0])
    for other in inputs[1:]:
        acc = fluid.layers.elementwise_add(acc, _unwrap(other))
    if _act_str(act):
        acc = getattr(fluid.layers, _act_str(act))(acc)
    first = inputs[0]
    return LayerOutput(acc, size=getattr(first, "size", None),
                       hwc=getattr(first, "hwc", None), name=name,
                       is_seq=getattr(first, "is_seq", False))


def concat_layer(input, act=None, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    inputs = list(input)
    imgs = [i for i in inputs if isinstance(i, LayerOutput)
            and i.hwc is not None]
    if len(imgs) == len(inputs):
        vars_ = [_as_image_var(i)[0] for i in inputs]
        out = fluid.layers.concat(vars_, axis=1)   # channel concat
        c = sum(i.hwc[0] for i in inputs)
        h, w = inputs[0].hwc[1], inputs[0].hwc[2]
        if _act_str(act):
            out = getattr(fluid.layers, _act_str(act))(out)
        return LayerOutput(out, size=c * h * w, hwc=(c, h, w), name=name)
    vars_ = [_unwrap(i) for i in inputs]
    out = fluid.layers.concat(vars_, axis=1)
    if _act_str(act):
        out = getattr(fluid.layers, _act_str(act))(out)
    size = sum(i.size for i in inputs if isinstance(i, LayerOutput))
    return LayerOutput(out, size=size or None, name=name,
                       is_seq=any(getattr(i, "is_seq", False)
                                  for i in inputs))


def dropout_layer(input, dropout_rate, name=None):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.dropout(_unwrap(input), dropout_rate)
    return LayerOutput(out, size=getattr(input, "size", None),
                       hwc=getattr(input, "hwc", None), name=name,
                       is_seq=getattr(input, "is_seq", False))


def embedding_layer(input, size, param_attr=None, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    var = _unwrap(input, kind="seq_ids")
    vocab = input.size if isinstance(input, LayerOutput) and input.size \
        else input._data_size
    out = fluid.layers.embedding(var, size=(vocab, size),
                                 param_attr=_fluid_param_attr(param_attr))
    return LayerOutput(out, size=size, is_seq=True, name=name)


def lstmemory(input, size=None, reverse=False, act=None,
              gate_act=None, state_act=None, name=None, param_attr=None,
              bias_attr=True, **kw):
    """input must be width 4*size (the reference requires the projection done
    by a preceding mixed/fc layer, layers.py lstmemory docs)."""
    import paddle_tpu_torch.fluid as fluid
    var = _unwrap(input)
    in_size = input.size if isinstance(input, LayerOutput) else None
    size = size or (in_size // 4 if in_size else None)
    hidden, _ = fluid.layers.dynamic_lstm(
        var, size=size * 4, is_reverse=reverse,
        gate_activation=_act_str(gate_act) or "sigmoid",
        cell_activation=_act_str(state_act) or "tanh",
        candidate_activation=_act_str(act) or "tanh",
        param_attr=_fluid_param_attr(param_attr))
    return LayerOutput(hidden, size=size, is_seq=True, name=name)


def simple_lstm(input, size, reverse=False, mat_param_attr=None,
                bias_param_attr=True, inner_param_attr=None, act=None,
                gate_act=None, state_act=None, name=None, **kw):
    """networks.py simple_lstm: mixed(4*size, linear) + lstmemory."""
    proj = fc_layer(input, size * 4, act=LinearActivation(),
                    param_attr=mat_param_attr, bias_attr=bias_param_attr)
    return lstmemory(proj, size=size, reverse=reverse, act=act,
                     gate_act=gate_act, state_act=state_act,
                     param_attr=inner_param_attr, name=name)


def grumemory(input, size=None, reverse=False, act=None, gate_act=None,
              name=None, param_attr=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    var = _unwrap(input)
    in_size = input.size if isinstance(input, LayerOutput) else None
    size = size or (in_size // 3 if in_size else None)
    hidden = fluid.layers.dynamic_gru(
        var, size=size, is_reverse=reverse,
        candidate_activation=_act_str(act) or "tanh",
        gate_activation=_act_str(gate_act) or "sigmoid",
        param_attr=_fluid_param_attr(param_attr))
    return LayerOutput(hidden, size=size, is_seq=True, name=name)


def simple_gru(input, size, reverse=False, act=None, gate_act=None,
               name=None, **kw):
    proj = fc_layer(input, size * 3, act=LinearActivation())
    return grumemory(proj, size=size, reverse=reverse, act=act,
                     gate_act=gate_act, name=name)


def _seq_select(input, which, agg_level=None, stride=-1, name=None):
    """first_seq/last_seq with the reference's agg_level/stride axes
    (layers.py first_seq:1395/last_seq:1353: stride>0 emits one result per
    stride-window — a sequence; TO_SEQUENCE pools inner sequences of a
    nested input)."""
    from ..fluid.layer_helper import LayerHelper
    var = _unwrap(input, kind="seq_dense")
    helper = LayerHelper(f"{which.lower()}_seq", name=name)
    attrs = {"pooltype": which}
    is_seq_out = False
    if stride and stride > 0:
        attrs["stride"] = int(stride)
        is_seq_out = True
    if agg_level == AggregateLevel.TO_SEQUENCE:
        attrs["agg_level"] = "seq"
        is_seq_out = True
    out = helper.create_tmp_variable(var.dtype,
                                     lod_level=1 if is_seq_out else 0)
    helper.append_op("sequence_pool", inputs={"X": [var.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return LayerOutput(out, size=getattr(input, "size", None), name=name,
                       is_seq=is_seq_out)


def last_seq(input, agg_level=None, stride=-1, name=None, **kw):
    return _seq_select(input, "LAST", agg_level, stride, name)


def first_seq(input, agg_level=None, stride=-1, name=None, **kw):
    return _seq_select(input, "FIRST", agg_level, stride, name)


def pooling_layer(input, pooling_type=None, agg_level=None, stride=-1,
                  name=None, **kw):
    ptype = {"max": "MAX", "avg": "AVERAGE",
             "sum": "SUM"}[(pooling_type or MaxPooling()).pool_type]
    return _seq_select(input, ptype, agg_level, stride, name)


def cross_entropy(input, label, name=None, coeff=1.0, weight=None, **kw):
    """Cost over an already-softmaxed input (the reference image configs
    apply SoftmaxActivation on the last fc, then cross_entropy); ``weight``
    scales each sample's cost (the reference's weight data layer)."""
    import paddle_tpu_torch.fluid as fluid
    lab = _unwrap(label, kind="label")
    ce = fluid.layers.cross_entropy(_unwrap(input), lab)
    if weight is not None:
        ce = fluid.layers.elementwise_mul(ce, _unwrap(weight))
    cost = fluid.layers.mean(ce)
    if coeff != 1.0:
        cost = fluid.layers.scale(cost, scale=float(coeff))
    return LayerOutput(cost, size=1, name=name)


def classification_cost(input, label, name=None, weight=None, **kw):
    return cross_entropy(input, label, name=name, weight=weight)


def regression_cost(input, label, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    lab = _unwrap(label)
    cost = fluid.layers.mean(fluid.layers.square_error_cost(_unwrap(input),
                                                            lab))
    return LayerOutput(cost, size=1, name=name)


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, param_attr=None, name=None, **kw):
    """Reference conv_projection (layers.py) is a projection for
    concat/mixed layers; under eager fluid lowering a projection IS a conv
    output, so this is img_conv_layer without activation."""
    return img_conv_layer(input, filter_size=filter_size,
                          num_filters=num_filters,
                          num_channels=num_channels, stride=stride,
                          padding=padding, param_attr=param_attr,
                          act=LinearActivation(), name=name)


def img_conv_group(input, conv_num_filter, num_channels=None,
                   pool_size=None, pool_stride=1, pool_type=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_batchnorm_drop_rate=None, conv_with_batchnorm=False,
                   pool_padding=0, **kw):
    """networks.py img_conv_group: conv (+optional BN) stack then one pool."""
    tmp = input
    n = len(conv_num_filter)

    def per(v, i):
        return v[i] if isinstance(v, (list, tuple)) else v

    for i, nf in enumerate(conv_num_filter):
        tmp = img_conv_layer(
            tmp, filter_size=per(conv_filter_size, i), num_filters=nf,
            num_channels=num_channels if i == 0 else None,
            padding=per(conv_padding, i),
            act=None if per(conv_with_batchnorm, i) else conv_act)
        if per(conv_with_batchnorm, i):
            tmp = batch_norm_layer(tmp, act=conv_act)
            dr = per(conv_batchnorm_drop_rate, i) \
                if conv_batchnorm_drop_rate else None
            if dr:
                tmp = dropout_layer(tmp, dr)
    return img_pool_layer(tmp, pool_size=pool_size, stride=pool_stride,
                          padding=pool_padding, pool_type=pool_type)


# ---------------------------------------------------------------------------
# topology extraction
# ---------------------------------------------------------------------------

class Topology:
    """What a parsed config yields: the cost var (fluid), data layers in
    declaration order, and an optimizer built from settings() — everything
    paddle_tpu_torch.v2.SGD needs."""

    def __init__(self, cost, outputs, data_layers, settings_dict,
                 data_sources):
        self.cost = cost
        self.outputs = outputs
        self.data_layers = list(data_layers)
        self.settings = dict(settings_dict)
        self.data_sources = dict(data_sources)

    @property
    def feed_order(self):
        return [d.name for d in self.data_layers if not d.is_pending]

    def create_optimizer(self):
        import paddle_tpu_torch.fluid as fluid
        lr = self.settings.get("learning_rate", 1e-3)
        method = self.settings.get("learning_method")
        reg = self.settings.get("regularization")
        reg = reg.to_fluid() if reg is not None else None
        if method is None:
            return fluid.optimizer.SGD(learning_rate=lr, regularization=reg)
        return method.create(lr, regularization=reg)


def get_topology():
    if not _OUTPUTS:
        raise RuntimeError("config declared no outputs(...)")
    cost_node = _OUTPUTS[-1]
    cost = cost_node.var if isinstance(cost_node, LayerOutput) else cost_node
    return Topology(cost, list(_OUTPUTS), _DATA_LAYERS, _SETTINGS,
                    _DATA_SOURCES)


# ``paddle.trainer_config_helpers`` and any ``paddle_tpu`` module, never
# ``paddle_tpu_torch`` (the ``\b`` after ``paddle_tpu`` fails before ``_``)
_PACKAGE_NAMES = re.compile(
    r"\bpaddle_tpu\b|\bpaddle(?=\.trainer_config_helpers\b)")


def parse_config(source, config_args=None, main_program=None,
                 startup_program=None, sequence_inputs=()):
    """Run a v2 config script (source text or file path) against fresh (or
    given) fluid programs — the ``paddle train --config=X.py
    --config_args=...`` entry point. Returns (topology, main, startup).

    ``sequence_inputs``: data-layer names whose feeds are token/feature
    SEQUENCES (the information the reference's data provider supplies at
    runtime)."""
    import paddle_tpu_torch.fluid as fluid
    import os

    _reset_config()
    _SEQUENCE_HINTS.update(sequence_inputs)
    if config_args:
        set_config_args(**config_args)
    if os.path.exists(source):
        with open(source) as f:
            source = f.read()
    # py2-era compatibility shim so reference configs run unedited: the
    # benchmark configs are python2 (xrange) and import the reference
    # package (``paddle.``) or the JAX package (``paddle_tpu.``); both map
    # onto this package, whose name neither pattern matches
    source = _PACKAGE_NAMES.sub("paddle_tpu_torch", source)
    source = source.replace("xrange", "range")

    main = main_program or fluid.Program()
    startup = startup_program or fluid.Program()
    glb = {"__name__": "__paddle_tpu_config__"}
    exec("from paddle_tpu_torch.trainer_config_helpers import *", glb)
    with fluid.program_guard(main, startup):
        exec(compile(source, "<v2-config>", "exec"), glb)
        topo = get_topology()
    return topo, main, startup


# ---------------------------------------------------------------------------
# DSL breadth: the layers that map 1:1 onto registered ops
# (reference trainer_config_helpers/layers.py; validated by running the
# reference's own tests/configs through parse_config)
# ---------------------------------------------------------------------------

class ExpActivation(_Activation):
    act = "exp"


class AbsActivation(_Activation):
    act = "abs"


class SquareActivation(_Activation):
    act = "square"


class BReluActivation(_Activation):
    act = "brelu"


class SoftReluActivation(_Activation):
    act = "soft_relu"


class STanhActivation(_Activation):
    act = "stanh"


class AggregateLevel:
    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"


class ExpandLevel:
    FROM_NO_SEQUENCE = AggregateLevel.TO_NO_SEQUENCE
    FROM_SEQUENCE = AggregateLevel.TO_SEQUENCE


def _unary_layer(op_type, input, name=None, attrs=None, **meta):
    helper_var = _unwrap(input)
    from ..fluid.layer_helper import LayerHelper
    helper = LayerHelper(op_type, name=name)
    out = helper.create_tmp_variable(
        helper_var.dtype, shape=helper_var.shape,
        lod_level=helper_var.lod_level)
    helper.append_op(op_type, inputs={"X": [helper_var.name]},
                     outputs={"Out": [out.name]}, attrs=attrs or {})
    return LayerOutput(out, size=getattr(input, "size", None),
                       hwc=getattr(input, "hwc", None),
                       is_seq=getattr(input, "is_seq", False), name=name)


def clip_layer(input, min, max, name=None, **kw):
    return _unary_layer("clip", input, name=name,
                        attrs={"min": float(min), "max": float(max)})


def scaling_layer(input, weight, name=None, **kw):
    """Row-wise scale by a [N, 1] weight layer (layers.py scaling_layer)."""
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.elementwise_mul(_unwrap(input), _unwrap(weight),
                                       axis=0)
    return LayerOutput(out, size=getattr(input, "size", None), name=name,
                       is_seq=getattr(input, "is_seq", False))


def slope_intercept_layer(input, slope=1.0, intercept=0.0, name=None, **kw):
    return _unary_layer("scale", input, name=name,
                        attrs={"scale": float(slope),
                               "bias": float(intercept)})


def power_layer(input, power, name=None, **kw):
    return _unary_layer("pow", input, name=name,
                        attrs={"factor": float(power)})


def trans_layer(input, name=None, **kw):
    """2-D transpose (layers.py trans_layer over TransLayer)."""
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.transpose(_unwrap(input), perm=[1, 0])
    return LayerOutput(out, size=getattr(input, "size", None), name=name)


def interpolation_layer(input, weight, name=None, **kw):
    """w * in0 + (1-w) * in1 with a [N, 1] weight (layers.py
    interpolation_layer)."""
    import paddle_tpu_torch.fluid as fluid
    a, b = input
    w = _unwrap(weight)
    av = fluid.layers.elementwise_mul(_unwrap(a), w, axis=0)
    one_minus = fluid.layers.scale(w, scale=-1.0, bias=1.0)
    bv = fluid.layers.elementwise_mul(_unwrap(b), one_minus, axis=0)
    out = fluid.layers.elementwise_add(av, bv)
    return LayerOutput(out, size=getattr(a, "size", None), name=name)


def dotmul_operator(a, b, scale=1.0, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.elementwise_mul(_unwrap(a), _unwrap(b))
    if scale != 1.0:
        out = fluid.layers.scale(out, scale=float(scale))
    return LayerOutput(out, size=getattr(a, "size", None))


def cos_sim(a, b, scale=1.0, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.cos_sim(_unwrap(a), _unwrap(b))
    if scale != 1.0:
        out = fluid.layers.scale(out, scale=float(scale))
    return LayerOutput(out, size=1, name=name)


def maxout_layer(input, groups, num_channels=None, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    var, (c, h, w) = _as_image_var(input, num_channels)
    out = fluid.layers.maxout(var, groups=groups)
    oc = c // groups
    return LayerOutput(out, size=oc * h * w, hwc=(oc, h, w), name=name)


def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, name=None, **kw):
    """Zero-pad the C/H/W dims of an image layer (layers.py pad_layer)."""
    import paddle_tpu_torch.fluid as fluid
    var, (c, h, w) = _as_image_var(input, None)
    pc = list(pad_c or [0, 0])
    ph = list(pad_h or [0, 0])
    pw = list(pad_w or [0, 0])
    out = fluid.layers.pad(var, [0, 0] + pc + ph + pw)
    nc, nh, nw = c + sum(pc), h + sum(ph), w + sum(pw)
    return LayerOutput(out, size=nc * nh * nw, hwc=(nc, nh, nw), name=name)


def expand_layer(input, expand_as, expand_level=None, name=None, **kw):
    """Tile each row of ``input`` along the matching sequence of
    ``expand_as`` (layers.py expand_layer -> sequence_expand)."""
    import paddle_tpu_torch.fluid as fluid
    if expand_level == ExpandLevel.FROM_SEQUENCE:
        raise NotImplementedError(
            "expand_layer FROM_SEQUENCE (sub-sequence granularity) is not "
            "supported; FROM_NO_SEQUENCE covers the dense->sequence case")
    out = fluid.layers.sequence_expand(_unwrap(input), _unwrap(expand_as))
    return LayerOutput(out, size=getattr(input, "size", None), is_seq=True,
                       name=name)


def ctc_layer(input, label, size=None, blank=None, norm_by_times=False,
              name=None, **kw):
    """Mean CTC cost (layers.py ctc_layer; the fluid warpctc op implements
    both the legacy ctc and warp-ctc contracts — delegate)."""
    return warp_ctc_layer(input, label, blank=blank if blank is not None
                          else (size - 1 if size else 0),
                          norm_by_times=norm_by_times, name=name)


def warp_ctc_layer(input, label, size=None, blank=0, norm_by_times=False,
                   name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.mean(fluid.layers.warpctc(
        _unwrap(input), _unwrap(label, kind="seq_ids"), blank=blank,
        norm_by_times=norm_by_times))
    return LayerOutput(out, size=1, name=name)


def crf_layer(input, label, size=None, param_attr=None, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.mean(fluid.layers.linear_chain_crf(
        _unwrap(input), _unwrap(label, kind="seq_ids"),
        param_attr=_fluid_param_attr(param_attr)))
    return LayerOutput(out, size=1, name=name)


def rank_cost(left, right, label, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.mean(fluid.layers.rank_loss(
        _unwrap(label), _unwrap(left), _unwrap(right)))
    return LayerOutput(out, size=1, name=name)


def huber_regression_cost(input, label, delta=1.0, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    from ..fluid.layer_helper import LayerHelper
    helper = LayerHelper("huber_loss", name=name)
    residual = helper.create_tmp_variable("float32")
    out = helper.create_tmp_variable("float32")
    helper.append_op("huber_loss",
                     inputs={"X": [_unwrap(input).name],
                             "Y": [_unwrap(label).name]},
                     outputs={"Out": [out.name],
                              "Residual": [residual.name]},
                     attrs={"delta": float(delta)})
    import paddle_tpu_torch.fluid as fluid
    return LayerOutput(fluid.layers.mean(out), size=1, name=name)


def multi_binary_label_cross_entropy(input, label, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.mean(fluid.layers.sigmoid_cross_entropy_with_logits(
        _unwrap(input), _unwrap(label)))
    return LayerOutput(out, size=1, name=name)


def sum_cost(input, name=None, **kw):
    import paddle_tpu_torch.fluid as fluid
    from ..fluid.layer_helper import LayerHelper
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_tmp_variable("float32", shape=())
    helper.append_op("reduce_sum", inputs={"X": [_unwrap(input).name]},
                     outputs={"Out": [out.name]},
                     attrs={"reduce_all": True, "dim": 0, "keep_dim": False})
    return LayerOutput(out, size=1, name=name)


def mse_cost(input, label, name=None, **kw):
    return regression_cost(input, label, name=name)


def bidirectional_gru(input, size, return_seq=True, name=None, **kw):
    """fwd + reverse grumemory concatenated (networks.py
    bidirectional_gru)."""
    fwd = simple_gru(input, size)
    bwd = simple_gru(input, size, reverse=True)
    if return_seq:
        return concat_layer([fwd, bwd])
    return concat_layer([last_seq(fwd), first_seq(bwd)])


def bidirectional_lstm(input, size, return_seq=True, name=None, **kw):
    fwd = simple_lstm(input, size)
    bwd = simple_lstm(input, size, reverse=True)
    if return_seq:
        return concat_layer([fwd, bwd])
    return concat_layer([last_seq(fwd), first_seq(bwd)])


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride=1, num_channel=None, act=None,
                         pool_type=None, name=None, **kw):
    conv = img_conv_layer(input, filter_size=filter_size,
                          num_filters=num_filters,
                          num_channels=num_channel, padding=0, act=act)
    return img_pool_layer(conv, pool_size=pool_size, stride=pool_stride,
                          pool_type=pool_type)


# LayerOutput arithmetic + layer_math (reference trainer_config_helpers/
# math.py: `1 + x`, `x * y`, elementwise chains in config scripts)
def _lo_binary(self, other, op_type, reverse=False):
    import paddle_tpu_torch.fluid as fluid
    if isinstance(other, LayerOutput):
        fn = getattr(fluid.layers, op_type)
        a, b = (other, self) if reverse else (self, other)
        # the fluid out var inherits X's static shape, so the LARGER
        # operand must be X (the reference math.py special-cases the
        # size-1 operand the same way); a - b with a smaller becomes
        # -(b - a)
        # pending data layers carry their size in _data_size
        sa = a.size or a._data_size or 0
        sb = b.size or b._data_size or 0
        negate = False
        if sb > sa:
            if op_type == "elementwise_sub":
                negate = True
            a, b = b, a
        out = fn(_unwrap(a), _unwrap(b))
        if negate:
            out = fluid.layers.scale(out, scale=-1.0)
        return LayerOutput(out, size=a.size, is_seq=a.is_seq or b.is_seq,
                           hwc=a.hwc)
    scalar = float(other)
    if op_type == "elementwise_add":
        return slope_intercept_layer(self, 1.0, scalar)
    if op_type == "elementwise_sub":
        return slope_intercept_layer(self, -1.0 if reverse else 1.0,
                                     scalar if reverse else -scalar)
    if op_type == "elementwise_mul":
        return slope_intercept_layer(self, scalar, 0.0)
    raise TypeError(op_type)


LayerOutput.__add__ = lambda s, o: _lo_binary(s, o, "elementwise_add")
LayerOutput.__radd__ = LayerOutput.__add__
LayerOutput.__sub__ = lambda s, o: _lo_binary(s, o, "elementwise_sub")
LayerOutput.__rsub__ = lambda s, o: _lo_binary(s, o, "elementwise_sub",
                                               reverse=True)
LayerOutput.__mul__ = lambda s, o: _lo_binary(s, o, "elementwise_mul")
LayerOutput.__rmul__ = LayerOutput.__mul__


__all__ += [
    "ExpActivation", "AbsActivation", "SquareActivation", "BReluActivation",
    "SoftReluActivation", "STanhActivation", "AggregateLevel", "ExpandLevel",
    "clip_layer", "scaling_layer", "slope_intercept_layer", "power_layer",
    "trans_layer", "interpolation_layer", "dotmul_operator", "cos_sim",
    "maxout_layer", "pad_layer", "expand_layer", "ctc_layer",
    "warp_ctc_layer", "crf_layer", "rank_cost", "huber_regression_cost",
    "multi_binary_label_cross_entropy", "sum_cost", "mse_cost",
    "bidirectional_gru", "bidirectional_lstm", "simple_img_conv_pool",
]


class _LayerMath:
    """The config-script math namespace (reference trainer_config_helpers/
    math.py, exported as ``layer_math``): elementwise functions over
    LayerOutput."""

    @staticmethod
    def _u(op, x, attrs=None):
        return _unary_layer(op, x, attrs=attrs)

    def exp(self, x):
        return self._u("exp", x)

    def sqrt(self, x):
        return self._u("sqrt", x)

    def reciprocal(self, x):
        return self._u("reciprocal", x)

    def log(self, x):
        return self._u("log", x)

    def abs(self, x):
        return self._u("abs", x)

    def sigmoid(self, x):
        return self._u("sigmoid", x)

    def tanh(self, x):
        return self._u("tanh", x)

    def square(self, x):
        return self._u("square", x)

    def relu(self, x):
        return self._u("relu", x)


layer_math = _LayerMath()

__all__ += ["layer_math"]


def recurrent_layer(input, act=None, reverse=False, bias_attr=True,
                    param_attr=None, name=None, **kw):
    """Vanilla full-matrix recurrence over the input sequence (reference
    layers.py recurrent_layer -> gserver RecurrentLayer; size equals the
    input size)."""
    import paddle_tpu_torch.fluid as fluid
    out = fluid.layers.dynamic_vanilla_rnn(
        _unwrap(input, kind="seq_dense"),
        size=(input.size or input._data_size),
        act=_act_str(act) or "tanh", is_reverse=reverse,
        param_attr=_fluid_param_attr(param_attr),
        bias_attr=False if bias_attr is False
        else (None if bias_attr is True else _fluid_param_attr(bias_attr)))
    return LayerOutput(out, size=(input.size or input._data_size),
                       is_seq=True, name=name)


def block_expand_layer(input, num_channels=None, block_x=1, block_y=1,
                       stride_x=1, stride_y=1, padding_x=0, padding_y=0,
                       name=None, **kw):
    """Image -> sequence of flattened blocks (layers.py block_expand_layer;
    the fluid im2sequence op owns the patch walk)."""
    import paddle_tpu_torch.fluid as fluid
    var, (c, h, w) = _as_image_var(input, num_channels)
    out = fluid.layers.im2sequence(var, filter_size=[block_y, block_x],
                                   stride=[stride_y, stride_x],
                                   padding=[padding_y, padding_x])
    return LayerOutput(out, size=c * block_x * block_y, is_seq=True,
                       name=name)


__all__ += ["block_expand_layer", "recurrent_layer"]


# ---------------------------------------------------------------------------
# mixed_layer + projections (reference trainer_config_helpers/layers.py:867
# mixed_layer, :405+ projections) — the legacy DSL's composition primitive:
# ``with mixed_layer(size=n, act=a) as m: m += projection(...)`` sums the
# lowered projections, adds the optional bias, applies the activation.
# ---------------------------------------------------------------------------

class _Projection:
    def __init__(self, kind, input, param_attr=None, size=None, offset=None):
        self.kind = kind
        self.input = input
        self.param_attr = param_attr
        self.size = size
        self.offset = offset

    def lower(self, out_size):
        import paddle_tpu_torch.fluid as fluid

        x = _unwrap(self.input)
        in_size = getattr(self.input, "size", None) or \
            (x.shape[-1] if x.shape else None)
        if self.kind == "full":
            return fluid.layers.fc(input=x, size=out_size, act=None,
                                   bias_attr=False,
                                   param_attr=_fluid_param_attr(
                                       self.param_attr))
        if self.kind == "trans_full":
            # out.row = in.row @ W^T with W [out_size, in_size] — shared
            # against an fc whose weight is [in', out'] = [out_size, in_size]
            # (layers.py:468 trans_full_matrix_projection, the sharew case)
            from paddle_tpu_torch.fluid.layer_helper import LayerHelper
            helper = LayerHelper("trans_full_matrix_projection")
            w = helper.create_parameter(
                _fluid_param_attr(self.param_attr) or
                fluid.ParamAttr(), shape=(out_size, in_size),
                dtype="float32")
            return fluid.layers.matmul(x, w, transpose_y=True)
        if self.kind == "identity":
            if self.offset is None:
                # reference layers.py identity_projection config_assert:
                # without an offset the sizes must agree — silently cropping
                # to the first out_size columns would hide a wiring bug
                if in_size not in (None, out_size):
                    raise ValueError(
                        f"identity_projection: input size {in_size} != "
                        f"mixed_layer size {out_size} (pass offset= to "
                        "select a column window)")
                return x
            if self.offset == 0 and in_size in (None, out_size):
                return x
            # layers.py:548 identity_projection with offset: columns
            # [offset, offset+out_size)
            return fluid.layers.crop(
                x, shape=[-1, out_size], offsets=[0, int(self.offset)])
        if self.kind == "table":
            ids = _unwrap(self.input, "seq_ids")   # int64 id sequence
            return fluid.layers.embedding(
                input=ids, size=[in_size, out_size],
                param_attr=_fluid_param_attr(self.param_attr))
        if self.kind == "dotmul":
            from paddle_tpu_torch.fluid.layer_helper import LayerHelper
            helper = LayerHelper("dotmul_projection")
            w = helper.create_parameter(
                _fluid_param_attr(self.param_attr) or fluid.ParamAttr(),
                shape=(1, out_size), dtype="float32")
            return fluid.layers.elementwise_mul(x, w)
        raise NotImplementedError(
            f"projection kind {self.kind!r} inside mixed_layer (the "
            "context/conv projections lower through sequence_conv_pool / "
            "img_conv_layer instead)")


def full_matrix_projection(input, size=0, param_attr=None):
    return _Projection("full", input, param_attr, size)


def trans_full_matrix_projection(input, size=0, param_attr=None):
    return _Projection("trans_full", input, param_attr, size)


def identity_projection(input, offset=None, size=None):
    return _Projection("identity", input, None, size, offset)


def table_projection(input, size=0, param_attr=None):
    return _Projection("table", input, param_attr, size)


def dotmul_projection(input, param_attr=None):
    return _Projection("dotmul", input, param_attr)


class MixedLayer(LayerOutput):
    """The ``with mixed_layer(...) as m`` object: LayerOutput whose var is
    produced at context exit from the accumulated projections."""

    def __init__(self, size, act=None, bias_attr=False, name=None):
        super().__init__(var=None, size=size, name=name)
        self._mixed_act = act
        self._mixed_bias = bias_attr
        self._projs = []

    def __iadd__(self, proj):
        if not isinstance(proj, _Projection):
            raise TypeError(f"mixed_layer += expects a projection, got "
                            f"{type(proj).__name__}")
        self._projs.append(proj)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        self._lower()
        return False

    def _lower(self):
        import paddle_tpu_torch.fluid as fluid

        if self._var is not None:   # already materialized (a consumer
            return                  # inside the with-block forced it)
        if not self._projs:
            raise ValueError("mixed_layer exited with no projections")
        terms = [p.lower(self.size) for p in self._projs]
        total = terms[0]
        for t in terms[1:]:
            total = fluid.layers.elementwise_add(total, t)
        if self._mixed_bias not in (False, None):
            from paddle_tpu_torch.fluid.layer_helper import LayerHelper
            helper = LayerHelper("mixed_bias")
            battr = None if self._mixed_bias is True else self._mixed_bias
            b = helper.create_parameter(
                _fluid_param_attr(battr) or fluid.ParamAttr(),
                shape=(self.size,), dtype="float32", is_bias=True)
            total = fluid.layers.elementwise_add(total, b)
        act = _act_str(self._mixed_act)
        if act and act != "linear":
            total = getattr(fluid.layers, act)(total)
        self._var = total

    # pending-materialization guard: using the mixed layer before the with-
    # block ends (or calling it bare) lowers on demand
    def materialize(self, kind="dense"):
        if self._var is None:
            self._lower()
        return self._var


def mixed_layer(size=0, input=None, act=None, bias_attr=False, name=None,
                **kw):
    ml = MixedLayer(size=size, act=act, bias_attr=bias_attr, name=name)
    if input:
        for proj in (input if isinstance(input, (list, tuple)) else [input]):
            ml += proj
    return ml


def TrainData(spec=None, **kw):
    """Legacy proto data-source declaration (config_parser TrainData):
    recorded for introspection; the trainer contract feeds readers."""
    _DATA_SOURCES.update(train_data=spec)


def TestData(spec=None, **kw):
    _DATA_SOURCES.update(test_data=spec)


def SimpleData(files=None, feat_dim=0, context_len=0, buffer_capacity=0,
               **kw):
    return dict(kind="simple", files=files, feat_dim=feat_dim,
                context_len=context_len, buffer_capacity=buffer_capacity)


__all__ += ["mixed_layer", "full_matrix_projection",
            "trans_full_matrix_projection", "identity_projection",
            "table_projection", "dotmul_projection", "TrainData",
            "TestData", "SimpleData"]


def nce_layer(input, label, num_classes=None, weight=None,
              num_neg_samples=10, neg_distribution=None, param_attr=None,
              bias_attr=None, name=None, **kw):
    """NCE cost (reference layers.py nce_layer over NCELayer); the sampled
    negative distribution is uniform here — ``neg_distribution`` is
    accepted for config parity (the fluid nce op samples uniformly, like
    the reference's default when no distribution is given)."""
    import paddle_tpu_torch.fluid as fluid
    xs = input if isinstance(input, (list, tuple)) else [input]
    x = _unwrap(xs[0])
    if len(xs) > 1:
        x = fluid.layers.concat([_unwrap(v) for v in xs], axis=1)
    cost = fluid.layers.nce(
        input=x, label=_unwrap(label, "label"),
        num_total_classes=int(num_classes),
        num_neg_samples=int(num_neg_samples),
        sample_weight=None if weight is None else _unwrap(weight),
        param_attr=_fluid_param_attr(param_attr),
        bias_attr=_fluid_param_attr(bias_attr))
    out = fluid.layers.mean(cost)
    return LayerOutput(out, size=1, name=name)


__all__ += ["nce_layer", "CudnnAvgPooling", "CudnnMaxPooling"]


def hsigmoid(input, label, num_classes=None, name=None, param_attr=None,
             bias_attr=True, **kw):
    """Hierarchical sigmoid cost layer (reference layers.py hsigmoid over
    gserver HierarchicalSigmoidLayer): inputs are concatenated (the
    reference keeps one weight block per input; a single [num_classes-1,
    sum(sizes)] block is the same linear map), cost averaged over the
    batch. ``num_classes=None`` falls back to the label layer's size;
    ``bias_attr=None`` means default bias (the reference's
    wrap_bias_attr_default(has_bias=True) rule), False disables it."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.layer_helper import LayerHelper

    xs = input if isinstance(input, (list, tuple)) else [input]
    x = _unwrap(xs[0])
    if len(xs) > 1:
        x = fluid.layers.concat([_unwrap(v) for v in xs], axis=1)
    dim = 0
    for v in xs:
        d = getattr(v, "size", None)
        if not d:
            uv = _unwrap(v)
            d = uv.shape[-1] if uv.shape else None
        if not d or d < 0:
            raise ValueError(
                "hsigmoid: cannot infer an input's feature size (declare "
                "the layer size)")
        dim += int(d)
    if num_classes is None:
        num_classes = getattr(label, "size", None) or \
            getattr(label, "_data_size", None)
    if not num_classes or int(num_classes) <= 2:
        raise ValueError(
            "hsigmoid requires num_classes > 2 (reference layers.py "
            "hsigmoid config_assert)")
    helper = LayerHelper("hsigmoid", name=name)
    w = helper.create_parameter(
        _fluid_param_attr(param_attr) or fluid.ParamAttr(),
        shape=(int(num_classes) - 1, dim), dtype="float32")
    inputs = {"X": [x.name], "W": [w.name],
              "Label": [_unwrap(label, "label").name]}
    if bias_attr is not False:   # None == default bias, like the reference
        battr = None if bias_attr in (True, None) else bias_attr
        b = helper.create_parameter(
            _fluid_param_attr(battr) or fluid.ParamAttr(),
            shape=(1, int(num_classes) - 1), dtype="float32", is_bias=True)
        inputs["Bias"] = [b.name]
    cost = helper.create_tmp_variable("float32")
    helper.append_op("hsigmoid", inputs=inputs,
                     outputs={"Out": [cost.name]},
                     attrs={"num_classes": int(num_classes)})
    out = fluid.layers.mean(cost)
    return LayerOutput(out, size=1, name=name)


__all__ += ["hsigmoid"]
