"""paddle_tpu_torch.fluid — the user API ported so far (counterpart of
paddle_tpu/fluid/__init__.py): layers, Program/program_guard, Executor,
initializer, io, fuse_conv_bn, backward, optimizer, places, Scope and
flags."""

from .framework import (Program, Block, Operator, Variable, Parameter,
                        program_guard, default_main_program,
                        default_startup_program, switch_main_program,
                        switch_startup_program, unique_name,
                        reset_unique_name)
from ..core.executor import Executor, CPUPlace, CUDAPlace
from ..core.flags import set_flags, get_flag
from ..core.scope import Scope, global_scope
from .. import ops as _ops  # noqa: F401  (registers all op lowerings)

from . import layers
from . import initializer
from . import io
from . import backward
from . import optimizer
from .backward import append_backward
from .param_attr import ParamAttr
from .fusion import fuse_conv_bn

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter", "program_guard",
    "default_main_program", "default_startup_program", "switch_main_program",
    "switch_startup_program", "unique_name", "reset_unique_name",
    "Executor", "CPUPlace", "CUDAPlace", "Scope", "global_scope",
    "set_flags", "get_flag", "layers", "initializer", "io", "backward",
    "optimizer", "append_backward", "ParamAttr", "fuse_conv_bn",
]
