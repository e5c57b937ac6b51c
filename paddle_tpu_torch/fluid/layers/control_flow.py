"""Control-flow layer functions (counterpart of paddle_tpu/fluid/layers/
control_flow.py), so far the comparisons: less_than (reference :52),
which piecewise_decay builds, and equal (:562). While, Switch and the
rest wait for their ops."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def less_than(x, y, cond=None):
    """x < y elementwise, bool."""
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_tmp_variable("bool", shape=x.shape)
    helper.append_op("less_than", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]})
    return cond


def equal(x, y, cond=None):
    """x == y elementwise, bool."""
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_tmp_variable("bool", shape=x.shape,
                                          stop_gradient=True)
    helper.append_op("equal", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]})
    return cond


__all__ = ["less_than", "equal"]
