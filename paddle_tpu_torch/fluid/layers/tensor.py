"""Tensor layer functions (counterpart of paddle_tpu/fluid/layers/
tensor.py): create_tensor, create_global_var, cast,
concat, sums, scale, assign, fill_constant, fill_constant_batch_size_like,
ones, zeros, reshape, transpose, split, argmax and create_parameter."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def create_tensor(dtype, name=None, persistable=False):
    """An empty global variable (reference :14)."""
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_global_variable(shape=None, dtype=dtype,
                                         persistable=persistable, name=name)


def cast(x, dtype):
    """x in ``dtype`` (reference :20)."""
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op("cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dtype": dtype, "in_dtype": x.dtype})
    return out


def concat(input, axis=0):
    """The inputs joined along ``axis``; the output keeps the first
    input's LoD level (reference :30)."""
    helper = LayerHelper("concat")
    shapes = [v.shape for v in input]
    out_shape = None
    if all(s is not None for s in shapes):
        out_shape = list(shapes[0])
        out_shape[axis] = sum(s[axis] for s in shapes)
        out_shape = tuple(out_shape)
    out = helper.create_tmp_variable(input[0].dtype, shape=out_shape,
                                     lod_level=input[0].lod_level)
    helper.append_op("concat", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    """The inputs added (reference :43): one ``sum`` op."""
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_tmp_variable(input[0].dtype,
                                         shape=input[0].shape)
    helper.append_op("sum", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """scale·x + bias (reference :52)."""
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_tmp_variable(x.dtype, shape=x.shape,
                                     lod_level=x.lod_level)
    helper.append_op("scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def assign(input, output=None):
    """``input`` copied to ``output`` (reference :64)."""
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_tmp_variable(input.dtype, shape=input.shape)
    helper.append_op("assign", inputs={"X": [input.name]},
                     outputs={"Out": [output.name]})
    return output


def fill_constant(shape, dtype, value, out=None):
    """A ``shape`` tensor of ``value`` (reference :73)."""
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_tmp_variable(dtype, shape=tuple(shape),
                                         stop_gradient=True)
    helper.append_op("fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """fill_constant with one dim taken from ``input``'s batch
    (reference :84)."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_tmp_variable(dtype, shape=tuple(shape),
                                     stop_gradient=True)
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def ones(shape, dtype):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype):
    return fill_constant(shape, dtype, 0.0)


def reshape(x, shape, act=None):
    """x under ``shape`` (reference :107): 0 copies x's dim, -1 is
    inferred, at build time too when every dim of x is static."""
    helper = LayerHelper("reshape", act=act)
    known = [s if s != 0 else x.shape[i] for i, s in enumerate(shape)]
    if -1 in known and x.shape is not None \
            and all(s is not None and s > 0 for s in x.shape):
        total = 1
        for s in x.shape:
            total *= s
        rest = 1
        for s in known:
            if s != -1:
                rest *= s
        known[known.index(-1)] = total // rest if rest else -1
    out = helper.create_tmp_variable(x.dtype, shape=tuple(known))
    helper.append_op("reshape", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm):
    """x's dims permuted by ``perm`` (reference :129)."""
    helper = LayerHelper("transpose")
    out_shape = tuple(x.shape[p] for p in perm) if x.shape else None
    out = helper.create_tmp_variable(x.dtype, shape=out_shape)
    helper.append_op("transpose", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": list(perm)})
    return out


def split(x, num_or_sections, dim=-1):
    """x cut along ``dim`` into ``num_or_sections`` equal parts, or into
    parts of the listed widths (reference :138)."""
    helper = LayerHelper("split")
    axis = dim if dim >= 0 else len(x.shape) + dim
    if isinstance(num_or_sections, int):
        sections = []
        sizes = [x.shape[axis] // num_or_sections] * num_or_sections
    else:
        sections = list(num_or_sections)
        sizes = sections
    outs = []
    for size in sizes:
        shp = list(x.shape)
        shp[axis] = size
        outs.append(helper.create_tmp_variable(x.dtype, shape=tuple(shp)))
    helper.append_op("split", inputs={"X": [x.name]},
                     outputs={"Out": [o.name for o in outs]},
                     attrs={"axis": axis, "sections": sections,
                            "num": (num_or_sections
                                    if isinstance(num_or_sections, int)
                                    else 0)})
    return outs


def argmax(x, axis=-1):
    """The int64 index of the largest entry along ``axis`` (reference
    :163)."""
    helper = LayerHelper("argmax")
    shp = tuple(s for i, s in enumerate(x.shape)
                if i != (axis % len(x.shape)))
    out = helper.create_tmp_variable("int64", shape=shp, stop_gradient=True)
    helper.append_op("argmax", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global variable filled with ``value`` by a ``fill_constant`` in
    the main program (reference :186)."""
    helper = LayerHelper("create_global_var")
    var = helper.create_global_variable(shape=tuple(shape), dtype=dtype,
                                        persistable=persistable, name=name)
    helper.append_op("fill_constant", outputs={"Out": [var.name]},
                     attrs={"shape": list(shape), "value": float(value),
                            "dtype": dtype, "force_cpu": force_cpu})
    return var


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A trainable parameter outside any layer (reference :172)."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter")
    attr = ParamAttr.to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias=is_bias,
                                   default_initializer=default_initializer)


__all__ = ["create_tensor", "cast", "concat", "sums", "scale", "assign",
           "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
           "reshape", "transpose", "split", "argmax", "create_global_var",
           "create_parameter"]
