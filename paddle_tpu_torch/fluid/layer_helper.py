"""LayerHelper — creates parameters and temp variables and appends ops for
every layer function (counterpart of paddle_tpu/fluid/layer_helper.py)."""

from __future__ import annotations

from .framework import (default_main_program, default_startup_program,
                        unique_name)
from .param_attr import ParamAttr, WeightNormParamAttr
from .initializer import Xavier, Constant
from ..core import registry


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self.name = kwargs.get("name") or unique_name(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr.to_attr(attr)
        if attr.name is None:
            attr.name = unique_name(f"{self.name}.w")
        init = attr.initializer or default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else Xavier()
        if isinstance(attr, WeightNormParamAttr):
            return self._create_weight_normalized(attr, shape, dtype, init)
        param = self.block.create_parameter(
            attr.name, shape, dtype, trainable=attr.trainable,
            regularizer=attr.regularizer, gradient_clip=attr.gradient_clip)
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        param.initializer = init
        # mirror the parameter into the startup program + its init op
        sb = self.startup_program.global_block()
        sp = sb.create_parameter(attr.name, shape, dtype,
                                 trainable=attr.trainable)
        init(sp, sb)
        return param

    def _create_weight_normalized(self, attr, shape, dtype, init):
        """Weight normalization (reference :43-110): the trainable
        direction v and keep-dim magnitude g; the startup program sets v by
        ``init`` and g to ||v||, so training starts at w == v, and the main
        program recomputes w = v · g / ||v|| by ops, so the gradients reach
        v and g and every update renormalizes."""
        dim = attr.dim
        if dim is not None:
            if not -len(shape) <= dim < len(shape):
                raise ValueError(
                    f"WeightNormParamAttr dim={dim} out of range for a "
                    f"rank-{len(shape)} weight")
            dim %= len(shape)
        axes = [i for i in range(len(shape)) if i != dim]
        g_shape = tuple(1 if i in axes else s for i, s in enumerate(shape))

        base = dict(trainable=attr.trainable, regularizer=attr.regularizer,
                    gradient_clip=attr.gradient_clip)
        v = self.block.create_parameter(f"{attr.name}.wn_v", shape, dtype,
                                        **base)
        g = self.block.create_parameter(f"{attr.name}.wn_g", g_shape, dtype,
                                        **base)
        for p in (v, g):
            p.optimize_attr = {"learning_rate": attr.learning_rate}
        v.initializer = init

        sb = self.startup_program.global_block()
        sv = sb.create_parameter(f"{attr.name}.wn_v", shape, dtype,
                                 trainable=attr.trainable)
        init(sv, sb)
        sb.create_parameter(f"{attr.name}.wn_g", g_shape, dtype,
                            trainable=attr.trainable)
        self._append_norm_ops(sb, sv.name, g.name, axes, dtype, g_shape)

        norm = self.block.create_var(name=unique_name(f"{attr.name}.wn_norm"),
                                     dtype=dtype, shape=g_shape)
        self._append_norm_ops(self.block, v.name, norm.name, axes, dtype,
                              g_shape)
        scaled = self.block.create_var(
            name=unique_name(f"{attr.name}.wn_scaled"), dtype=dtype,
            shape=shape)
        self.append_op("elementwise_mul", inputs={"X": [v.name],
                                                  "Y": [g.name]},
                       outputs={"Out": [scaled.name]})
        w = self.block.create_var(name=unique_name(f"{attr.name}.wn_w"),
                                  dtype=dtype, shape=shape)
        self.append_op("elementwise_div", inputs={"X": [scaled.name],
                                                  "Y": [norm.name]},
                       outputs={"Out": [w.name]})
        return w

    @staticmethod
    def _append_norm_ops(block, src, dst, axes, dtype, g_shape):
        """dst = sqrt(sum(src², axes, keep_dim)), appended to ``block``."""
        sq = block.create_var(name=unique_name(f"{src}.sq"), dtype=dtype)
        block.append_op("square", inputs={"X": [src]},
                        outputs={"Out": [sq.name]})
        ssum = block.create_var(name=unique_name(f"{src}.ssum"), dtype=dtype,
                                shape=g_shape)
        block.append_op("reduce_sum", inputs={"X": [sq.name]},
                        outputs={"Out": [ssum.name]},
                        attrs={"dim": axes, "keep_dim": True,
                               "reduce_all": False})
        block.append_op("sqrt", inputs={"X": [ssum.name]},
                        outputs={"Out": [dst]})

    def create_tmp_variable(self, dtype, shape=None, lod_level=0,
                            stop_gradient=False):
        return self.block.create_var(
            name=unique_name(f"{self.name}.tmp"), dtype=dtype, shape=shape,
            lod_level=lod_level, stop_gradient=stop_gradient)

    def create_global_variable(self, shape, dtype, persistable=False,
                               name=None, stop_gradient=True):
        """A variable of the main program's global block (reference
        layer_helper.py:132)."""
        return self.main_program.global_block().create_var(
            name=name or unique_name(f"{self.name}.global"), shape=shape,
            dtype=dtype, persistable=persistable, stop_gradient=stop_gradient)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = self.block.append_op(type, inputs, outputs, attrs)
        info = registry.get_op_info(type)  # fail fast on unknown op types
        if info.infer_shape is not None:
            info.infer_shape(op, self.block)
        return op

    def append_bias_op(self, input_var, dim_start=1, bias_attr=None):
        """Add elementwise bias (reference layer_helper.py:148)."""
        if bias_attr is None:
            bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = input_var.shape[dim_start:]
        b = self.create_parameter(ParamAttr.to_attr(bias_attr), shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_tmp_variable(input_var.dtype, shape=input_var.shape,
                                       lod_level=input_var.lod_level)
        self.append_op("elementwise_add",
                       inputs={"X": [input_var.name], "Y": [b.name]},
                       outputs={"Out": [out.name]},
                       attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var, act=None):
        """Append the layer's activation op (reference layer_helper.py:165)."""
        act = act if act is not None else self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_tmp_variable(input_var.dtype, shape=input_var.shape,
                                       lod_level=input_var.lod_level)
        self.append_op(act_type, inputs={"X": [input_var.name]},
                       outputs={"Out": [out.name]}, attrs=act)
        return out
