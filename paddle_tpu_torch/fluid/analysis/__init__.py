"""paddle_tpu_torch.fluid.analysis — static analysis over Program IR
(counterpart of paddle_tpu/fluid/analysis/):

* :func:`verify_program` — structural verifier (PTL0xx errors): registry +
  slot arity, def-before-use dataflow with parent-block recursion, shadow
  re-inference of shapes/dtypes, in-place and grad-pairing contracts,
  fetch-clobber protection. Raises :class:`ProgramVerifyError`.
* :func:`lint_program` — quality rules (PTL1xx warnings): dead ops, unused
  vars, WAW hazards, sparse-grad densification, fp16 boundaries, baked
  batch sizes.
* wiring: the program-transforming passes (``append_backward``,
  ``fuse_conv_bn``, ``save_inference_model``'s prune, the
  GenerationEngine's phase rewrite) verify their output under the
  ``verify_passes`` flag; the Executor verifies once per program version
  under ``executor_verify``; ``load_inference_model`` verifies
  unconditionally. ``python -m paddle_tpu_torch.tools.lint_program`` is the
  command line over saved bundles.
"""

from . import slots  # installs the SlotSpec catalogue onto the registry
from .diagnostics import Diagnostic, ProgramVerifyError, ERROR, WARNING
from .lint import lint_program
from .verify import verify_calls, verify_pass_output, verify_program

__all__ = ["Diagnostic", "ProgramVerifyError", "ERROR", "WARNING",
           "lint_program", "verify_calls", "verify_pass_output",
           "verify_program"]
