"""Drop-in surface for ``from paddle.trainer_config_helpers import *`` —
reference configs (e.g. benchmark/paddle/image/resnet.py)
run after editing only that import to ``paddle_tpu_torch.trainer_config_helpers``.

The implementation lives in paddle_tpu_torch.v2.config_helpers (the DSL lowers
eagerly onto the fluid Program builder instead of compiling a ModelConfig
proto — see its module docstring).
"""

from ..v2.config_helpers import *          # noqa: F401,F403
from ..v2.config_helpers import __all__    # noqa: F401
