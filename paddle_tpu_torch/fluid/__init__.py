"""paddle_tpu_torch.fluid — the user API ported so far (counterpart of
paddle_tpu/fluid/__init__.py): layers, nets, Program/program_guard,
Executor, initializer, io, fuse_conv_bn, backward, optimizer, regularizer,
clip, evaluator, DataFeeder, average, places, Scope, flags, amp_guard, the
program verifier and lint (``analysis``), the LoD feed helpers and the
pserver transpilers (``DistributeTranspiler``,
``SimpleDistributeTranspiler``) and ``recordio_writer``."""

from .framework import (Program, Block, Operator, Variable, Parameter,
                        program_guard, default_main_program,
                        default_startup_program, switch_main_program,
                        switch_startup_program, unique_name,
                        reset_unique_name)
from ..core.amp import amp_guard
from ..core.executor import Executor, CPUPlace, CUDAPlace
from ..core.flags import set_flags, get_flag
from ..core.scope import Scope, global_scope
from ..core.lod import (LoDArray, pack_sequences, flat_to_lodarray,
                        lodarray_to_flat)
from .. import ops as _ops  # noqa: F401  (registers all op lowerings)

from . import analysis  # static analysis (also installs the SlotSpec catalogue)
from .analysis import ProgramVerifyError, lint_program, verify_program

from . import layers
from . import nets
from . import initializer
from . import io
from . import backward
from . import optimizer
from . import regularizer
from . import clip
from . import average
from . import evaluator
from .backward import append_backward
from .data_feeder import DataFeeder
from .param_attr import ParamAttr
from .fusion import fuse_conv_bn
from .distribute_transpiler import (DistributeTranspiler,
                                    SimpleDistributeTranspiler)
from . import recordio_writer

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter", "program_guard",
    "default_main_program", "default_startup_program", "switch_main_program",
    "switch_startup_program", "unique_name", "reset_unique_name",
    "Executor", "CPUPlace", "CUDAPlace", "Scope", "global_scope",
    "set_flags", "get_flag", "layers", "initializer", "io", "backward",
    "optimizer", "regularizer", "clip", "average", "DataFeeder",
    "append_backward", "ParamAttr", "fuse_conv_bn",
    "LoDArray", "pack_sequences", "flat_to_lodarray", "lodarray_to_flat",
    "amp_guard", "analysis", "ProgramVerifyError", "lint_program",
    "verify_program", "nets", "evaluator", "DistributeTranspiler",
    "SimpleDistributeTranspiler", "recordio_writer",
]
