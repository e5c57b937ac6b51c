"""Learning-rate schedules as graph ops over a step counter (counterpart of
paddle_tpu/fluid/layers/learning_rate_scheduler.py). Each schedule appends
ops computing the rate into a float32 [1] variable every step from the
int64 ``@LR_DECAY_COUNTER@``, which an ``increment`` prepended to the
program advances; an optimizer given that variable reads it as its
learning rate. On the card every op stays on the device: the arena
kernels read the rate there, with no host sync."""

from __future__ import annotations

import math

from ..framework import default_main_program, default_startup_program
from . import ops as _ops
from . import tensor
from .control_flow import less_than
from .nn import (elementwise_add, elementwise_div, elementwise_max,
                 elementwise_min, elementwise_sub)

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "autoincreased_step_counter"]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 [1] counter, ``begin`` during the first step and
    ``step`` more each step after (reference :25). Integral, so it never
    freezes where a float32 counter would, at 2^24."""
    name = counter_name or _COUNTER_NAME
    main_block = default_main_program().global_block()
    if main_block.has_var(name):
        return main_block.var(name)
    counter = main_block.create_var(name=name, shape=(1,), dtype="int64",
                                    persistable=True)
    startup_block = default_startup_program().global_block()
    startup_block.create_var(name=name, shape=(1,), dtype="int64",
                             persistable=True)
    startup_block.append_op(
        "fill_constant", outputs={"Out": [name]},
        attrs={"shape": [1], "value": float(begin - step),
               "dtype": "int64"})
    main_block.prepend_op("increment", inputs={"X": [name]},
                          outputs={"Out": [name]},
                          attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


def _float_step(counter_name=None):
    return tensor.cast(autoincreased_step_counter(counter_name), "float32")


def _scalar(value):
    return tensor.fill_constant(shape=[1], dtype="float32",
                                value=float(value))


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 · min(step^-0.5, step · warmup^-1.5)."""
    step = _float_step()
    a = _ops.pow(step, factor=-0.5)
    b = tensor.scale(step, scale=float(warmup_steps) ** -1.5)
    return tensor.scale(elementwise_min(a, b),
                        scale=float(d_model) ** -0.5)


def _div_steps(decay_steps, staircase):
    div = tensor.scale(_float_step(), scale=1.0 / float(decay_steps))
    return _ops.floor(div) if staircase else div


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr · decay_rate^(step / decay_steps), as exp(x · ln(decay_rate))."""
    div = _div_steps(decay_steps, staircase)
    return tensor.scale(_ops.exp(tensor.scale(
        div, scale=math.log(float(decay_rate)))),
        scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr · exp(−decay_rate · step / decay_steps)."""
    div = _div_steps(decay_steps, staircase)
    return tensor.scale(_ops.exp(tensor.scale(div,
                                              scale=-float(decay_rate))),
                        scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate · step / decay_steps)."""
    div = _div_steps(decay_steps, staircase)
    denom = tensor.scale(div, scale=float(decay_rate), bias=1.0)
    return tensor.scale(_ops.reciprocal(denom), scale=float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr − end_lr) · (1 − step / horizon)^power + end_lr: the step
    clamped to decay_steps, or with ``cycle`` the horizon stretched to
    decay_steps · max(1, ⌈step / decay_steps⌉)."""
    step = _float_step()
    if cycle:
        ratio = _ops.ceil(tensor.scale(step, scale=1.0 / float(decay_steps)))
        ratio = elementwise_max(ratio, _scalar(1.0))
        horizon = tensor.scale(ratio, scale=float(decay_steps))
    else:
        horizon = _scalar(float(decay_steps))
        step = elementwise_min(step, horizon)
    frac = elementwise_div(step, horizon)
    poly = _ops.pow(tensor.scale(frac, scale=-1.0, bias=1.0),
                    factor=float(power))
    return tensor.scale(poly,
                        scale=float(learning_rate) - float(end_learning_rate),
                        bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i], values[-1] after the last
    boundary (reference :129). Branch-free, as the reference builds it:
    values[-1] + Σ_i (values[i] − values[-1]) · [b_{i−1} ≤ step < b_i],
    each indicator the difference of two ``less_than``s of the int64
    counter (a float32 compare would misorder boundaries past 2^24)."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = autoincreased_step_counter()

    def below(b):
        bv = tensor.fill_constant(shape=[1], dtype="int64", value=float(b))
        return tensor.cast(less_than(step, bv), "float32")

    lr = _scalar(float(values[-1]))
    prev_below = None
    terms = []
    for i, b in enumerate(boundaries):
        ind = below(b)
        seg = ind if prev_below is None else elementwise_sub(ind, prev_below)
        terms.append(tensor.scale(seg,
                                  scale=float(values[i]) - float(values[-1])))
        prev_below = ind
    for t in terms:
        lr = elementwise_add(lr, t)
    return lr
