"""v2 optimizer API (reference python/paddle/v2/optimizer.py): optimizer
objects bundling the learning rate and regularization, handed to SGD as
``update_equation``. They build the corresponding fluid optimizer."""

from __future__ import annotations

from .config_helpers import (MomentumOptimizer, AdamOptimizer,
                             AdamaxOptimizer, RMSPropOptimizer,
                             AdaGradOptimizer, DecayedAdaGradOptimizer,
                             AdaDeltaOptimizer, L2Regularization)


class _V2Optimizer:
    spec_cls = None

    def __init__(self, learning_rate=1e-3, regularization=None, **kw):
        self.learning_rate = learning_rate
        self.regularization = regularization
        self._spec = self.spec_cls(**kw) if self.spec_cls else None

    def to_fluid(self):
        import paddle_tpu_torch.fluid as fluid
        reg = self.regularization.to_fluid() if self.regularization else None
        if self._spec is None:
            return fluid.optimizer.SGD(learning_rate=self.learning_rate,
                                       regularization=reg)
        return self._spec.create(self.learning_rate, regularization=reg)


class Momentum(_V2Optimizer):
    spec_cls = MomentumOptimizer

    def __init__(self, momentum=0.9, learning_rate=1e-3,
                 regularization=None, **kw):
        super().__init__(learning_rate, regularization, momentum=momentum)


class Adam(_V2Optimizer):
    spec_cls = AdamOptimizer

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, **kw):
        super().__init__(learning_rate, regularization, beta1=beta1,
                         beta2=beta2, epsilon=epsilon)


class Adamax(_V2Optimizer):
    spec_cls = AdamaxOptimizer

    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 regularization=None, **kw):
        super().__init__(learning_rate, regularization, beta1=beta1,
                         beta2=beta2)


class RMSProp(_V2Optimizer):
    spec_cls = RMSPropOptimizer

    def __init__(self, learning_rate=1e-3, rho=0.95, epsilon=1e-6,
                 regularization=None, **kw):
        super().__init__(learning_rate, regularization, rho=rho,
                         epsilon=epsilon)


class AdaGrad(_V2Optimizer):
    spec_cls = AdaGradOptimizer

    def __init__(self, learning_rate=1e-3, epsilon=1e-6,
                 regularization=None, **kw):
        super().__init__(learning_rate, regularization, epsilon=epsilon)


class DecayedAdaGrad(_V2Optimizer):
    spec_cls = DecayedAdaGradOptimizer

    def __init__(self, learning_rate=1e-3, rho=0.95, epsilon=1e-6,
                 regularization=None, **kw):
        super().__init__(learning_rate, regularization, rho=rho,
                         epsilon=epsilon)


class AdaDelta(_V2Optimizer):
    spec_cls = AdaDeltaOptimizer

    def __init__(self, learning_rate=1e-3, rho=0.95, epsilon=1e-6,
                 regularization=None, **kw):
        super().__init__(learning_rate, regularization, rho=rho,
                         epsilon=epsilon)


__all__ = ["Momentum", "Adam", "Adamax", "RMSProp", "AdaGrad",
           "DecayedAdaGrad", "AdaDelta", "L2Regularization"]
