"""Gradient clipping appended as graph ops between the backward and the
update (counterpart of paddle_tpu/fluid/clip.py). ``GradientClipByValue``
appends a ``clip`` per gradient, ``GradientClipByNorm`` a ``clip_by_norm``;
``GradientClipByGlobalNorm`` scales every gradient of its group by one
factor, clip_norm / max(‖g‖, clip_norm) with ‖g‖² summed over the group in
parameter order. A parameter takes its clip from ``ParamAttr.gradient_clip``
or ``set_gradient_clip``; ``Optimizer.minimize`` calls
``append_gradient_clip_ops`` right after the backward."""

from __future__ import annotations

from .framework import default_main_program, unique_name

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops"]


class BaseGradientClipAttr:
    def _append_clip_op(self, block, grad):
        """Append the ops clipping ``grad``; return the clipped variable."""
        raise NotImplementedError

    # a global-norm clip's group; per-gradient clips have none
    group_name = None


class ErrorClipByValue:
    """Kept for the reference's API: it clips the error (an output's
    gradient) of an op, which no ported backward reads."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _append_clip_op(self, block, grad):
        out = block.create_var(name=unique_name(grad.name + "_clip"),
                               shape=grad.shape, dtype=grad.dtype)
        block.append_op("clip", inputs={"X": [grad.name]},
                        outputs={"Out": [out.name]},
                        attrs={"min": self.min, "max": self.max})
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    """grad · clip_norm / max(‖grad‖, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_clip_op(self, block, grad):
        out = block.create_var(name=unique_name(grad.name + "_clip"),
                               shape=grad.shape, dtype=grad.dtype)
        block.append_op("clip_by_norm", inputs={"X": [grad.name]},
                        outputs={"Out": [out.name]},
                        attrs={"max_norm": self.clip_norm})
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient of a group times clip_norm / max(gnorm, clip_norm),
    gnorm = √(Σ ‖g_i‖²)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name


def set_gradient_clip(clip, param_list=None, program=None):
    """Give ``clip`` to every parameter of ``param_list`` (names or
    Parameters; default: all of the program's)."""
    program = program or default_main_program()
    if param_list is None:
        params = program.global_block().all_parameters()
    else:
        params = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for p in params:
        p.gradient_clip = clip


def _append_global_norm_group(block, group):
    """group: [(param, grad, clip)] of one group_name. Appends the norm,
    the factor and one ``elementwise_mul`` per gradient; returns {grad
    name: clipped grad}."""
    norms = {c.clip_norm for _p, _g, c in group}
    if len(norms) > 1:
        raise ValueError(
            f"GradientClipByGlobalNorm group "
            f"{group[0][2].group_name!r} has conflicting clip_norm values "
            f"{sorted(norms)}; use distinct group_name per clip_norm")
    clip_norm = group[0][2].clip_norm
    sq_names = []
    for _p, g, _c in group:
        sq = block.create_var(name=unique_name(g.name + "_sqn"),
                              shape=(1,), dtype="float32")
        block.append_op("squared_l2_norm", inputs={"X": [g.name]},
                        outputs={"Out": [sq.name]})
        sq_names.append(sq.name)
    total = block.create_var(name=unique_name("gclip_sumsq"), shape=(1,),
                             dtype="float32")
    block.append_op("sum", inputs={"X": sq_names},
                    outputs={"Out": [total.name]})
    gnorm = block.create_var(name=unique_name("gclip_gnorm"), shape=(1,),
                             dtype="float32")
    block.append_op("sqrt", inputs={"X": [total.name]},
                    outputs={"Out": [gnorm.name]})
    cn = block.create_var(name=unique_name("gclip_cn"), shape=(1,),
                          dtype="float32")
    block.append_op("fill_constant", outputs={"Out": [cn.name]},
                    attrs={"shape": [1], "value": clip_norm,
                           "dtype": "float32"})
    denom = block.create_var(name=unique_name("gclip_denom"), shape=(1,),
                             dtype="float32")
    block.append_op("elementwise_max", inputs={"X": [gnorm.name],
                                               "Y": [cn.name]},
                    outputs={"Out": [denom.name]})
    factor = block.create_var(name=unique_name("gclip_factor"), shape=(1,),
                              dtype="float32")
    block.append_op("elementwise_div", inputs={"X": [cn.name],
                                               "Y": [denom.name]},
                    outputs={"Out": [factor.name]})
    out = {}
    for _p, g, _c in group:
        ng = block.create_var(name=unique_name(g.name + "_gclip"),
                              shape=g.shape, dtype=g.dtype)
        block.append_op("elementwise_mul",
                        inputs={"X": [g.name], "Y": [factor.name]},
                        outputs={"Out": [ng.name]})
        out[g.name] = ng
    return out


def append_gradient_clip_ops(params_grads):
    """[(param, grad)] -> [(param, clipped grad)] by each parameter's clip:
    one op per gradient for the value and norm clips; the global-norm clips
    grouped by group_name, each group sharing one factor."""
    groups = {}
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip", None)
        if clip is not None and g is not None \
                and isinstance(clip, GradientClipByGlobalNorm):
            groups.setdefault(clip.group_name, []).append((p, g, clip))
    global_new = {}
    for group in groups.values():
        global_new.update(_append_global_norm_group(group[0][1].block,
                                                    group))
    result = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip", None)
        if clip is None or g is None:
            result.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            result.append((p, global_new[g.name]))
        elif isinstance(clip, BaseGradientClipAttr):
            result.append((p, clip._append_clip_op(g.block, g)))
        else:
            raise TypeError(
                f"param {p.name}: unknown gradient_clip {clip!r}")
    return result
