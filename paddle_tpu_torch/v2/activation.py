"""v2 activation objects (reference python/paddle/v2/activation.py renames
trainer_config_helpers activations without the Activation suffix)."""

from .config_helpers import (ReluActivation as Relu,
                             LinearActivation as Linear,
                             SoftmaxActivation as Softmax,
                             SigmoidActivation as Sigmoid,
                             TanhActivation as Tanh)

Identity = Linear

__all__ = ["Relu", "Linear", "Identity", "Softmax", "Sigmoid", "Tanh"]
