"""v2-style trainer API (counterpart of paddle_tpu/v2/__init__.py): the
event-driven training loop of the legacy generation (reference
python/paddle/v2/trainer.py SGD.train + event.py), provided over the
port's fluid Programs.

The reference v2 stack wraps a C++ GradientMachine built from the layer-DSL
config compiler (trainer_config_helpers + config_parser.py, ~16k LoC of
legacy front end); the fluid Program IS this framework's topology format, so
the v2 capability that carries forward is the TRAINER CONTRACT: reader in,
BeginPass/BeginIteration/EndIteration/EndPass events out, feeding maps, and
test() over a held-out reader — used exactly like
``paddle.v2.trainer.SGD(cost, parameters, optimizer).train(...)``.
"""

from . import event
from .trainer import SGD
from . import (activation, attr, config_helpers, data_feeder, data_type,
               evaluator, image, layer, master, networks, op, optimizer,
               parameters, plot, pooling, topology)
from .config_helpers import parse_config
from .inference import infer, Inference
from .topology import Topology

# paddle.v2.trainer.SGD spelling (reference v2/trainer.py)
from . import trainer
from . import inference

# reference v2/__init__.py re-exports: paddle.batch, paddle.reader,
# paddle.dataset (the port's own reader/ and dataset/ packages: one
# implementation, two spellings)
from ..reader.minibatch import batch
from .. import reader
from .. import dataset
minibatch = reader.minibatch

__all__ = ["event", "SGD", "trainer", "layer", "activation", "pooling",
           "attr", "data_type", "optimizer", "parameters", "config_helpers",
           "parse_config", "infer", "Inference", "topology", "Topology",
           "inference", "image", "plot", "networks", "evaluator", "op",
           "master", "batch", "minibatch", "reader", "dataset", "init"]


def init(**kwargs):
    """paddle.init(use_gpu=..., trainer_count=...) (reference
    v2/__init__.py:127): fold PADDLE_INIT_* environment variables and
    kwargs into the flags registry. ``use_gpu=False`` (or
    PADDLE_INIT_USE_GPU=0) makes every v2 entry point that is not given a
    place (SGD, Inference, infer) run on the CPU; the default is the card.
    Unknown reference flags are recorded without error so unedited
    reference scripts run. Returns the arguments."""
    import os as _os

    from ..core.flags import _FLAGS, set_flags
    from .inference import _INIT

    args = {}
    for ek, ev in _os.environ.items():
        if ek.startswith("PADDLE_INIT_"):
            args[ek[len("PADDLE_INIT_"):].lower()] = ev
    args.update(kwargs)
    known = {k: v for k, v in args.items() if k in _FLAGS}
    if known:
        set_flags(known)
    _INIT.clear()
    _INIT.update(args)
    return args
