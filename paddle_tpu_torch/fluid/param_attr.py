"""ParamAttr — per-parameter configuration (counterpart of
paddle_tpu/fluid/param_attr.py)."""

from __future__ import annotations

from .initializer import Initializer


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            a = ParamAttr()
            a.trainable = arg
            return a
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")
