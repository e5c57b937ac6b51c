"""Weight decay appended as graph ops (counterpart of
paddle_tpu/fluid/regularizer.py): ``append_regularization_ops`` turns each
gradient into ``sum(grad, coeff·f(param))`` in front of the update op, with
f the identity (``L2Decay``) or sign (``L1Decay``). A parameter's own
``regularizer`` wins over the optimizer's."""

from __future__ import annotations

from .framework import unique_name


class WeightDecayRegularizer:
    def _append(self, block, param):
        """Append the ops of the decay term of ``param``; return its
        variable."""
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """coeff·param: one ``scale`` op."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, block, param):
        out = block.create_var(name=unique_name(param.name + "_l2decay"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [param.name]},
                        outputs={"Out": [out.name]},
                        attrs={"scale": self._coeff})
        return out


class L1Decay(WeightDecayRegularizer):
    """coeff·sign(param): a ``sign`` op and a ``scale`` op."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, block, param):
        sgn = block.create_var(name=unique_name(param.name + "_sign"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op("sign", inputs={"X": [param.name]},
                        outputs={"Out": [sgn.name]})
        out = block.create_var(name=unique_name(param.name + "_l1decay"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [sgn.name]},
                        outputs={"Out": [out.name]},
                        attrs={"scale": self._coeff})
        return out


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay


def append_regularization_ops(params_grads, regularization=None):
    """[(param, grad)] -> [(param, decayed grad)]: a ``sum`` of the gradient
    and the decay term for every parameter with a regularizer, its own or
    else ``regularization``; the others pass through."""
    out = []
    for param, grad in params_grads:
        reg = param.regularizer or regularization
        if reg is None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = reg._append(block, param)
        new_grad = block.create_var(name=unique_name(grad.name + "_reg"),
                                    shape=param.shape, dtype=param.dtype)
        block.append_op("sum", inputs={"X": [grad.name, decay.name]},
                        outputs={"Out": [new_grad.name]})
        out.append((param, new_grad))
    return out


__all__ = ["L2Decay", "L1Decay", "L2DecayRegularizer", "L1DecayRegularizer",
           "append_regularization_ops"]
