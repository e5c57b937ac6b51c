"""Diagnostic objects + the stable PTL code space shared by the verifier
and the lint framework (counterpart of
paddle_tpu/fluid/analysis/diagnostics.py; the codes are the reference's).

Programs are plain Python objects that transform passes rewrite, so
structural validity is a separate, machine-checkable contract:
every finding is a :class:`Diagnostic` with a STABLE code (``PTL0xx`` =
verifier/structural, ``PTL1xx`` = lint/quality), a severity, and op-index +
block provenance so a failing pass names the exact op it corrupted.

Codes are append-only: a released code never changes meaning (tests and
downstream tooling key on them, like compiler warning flags).
"""

from __future__ import annotations

import dataclasses

# ---- verifier (structural errors) ----
UNKNOWN_OP = "PTL001"           # op type absent from the registry
SLOT_ARITY = "PTL002"           # slot names/arity disagree with the SlotSpec
UNDEFINED_VAR = "PTL003"        # op references a var no block declares
USE_BEFORE_DEF = "PTL004"       # dataflow: read before any producing op
INFER_SHAPE_FAILED = "PTL005"   # registered infer_shape raised in the shadow
SHAPE_MISMATCH = "PTL006"       # annotated shape disagrees with re-inference
DTYPE_MISMATCH = "PTL007"       # annotated dtype disagrees with re-inference
IN_PLACE_BROKEN = "PTL008"      # in_place op output does not rebind an input
GRAD_ORPHAN = "PTL009"          # @GRAD var with no forward twin
FETCH_CLOBBER = "PTL010"        # fetch target overwritten after consumption

# ---- lint (quality warnings) ----
DEAD_OP = "PTL101"              # outputs never consumed / fetched / state
UNUSED_VAR = "PTL102"           # declared var no op touches
WRITE_AFTER_WRITE = "PTL103"    # duplicate-output WAW hazard
SPARSE_DENSIFIED = "PTL104"     # is_sparse lookup_table grad path densifies
FP16_BOUNDARY = "PTL105"        # mixed fp16/fp32 operands without a cast
RETRACE_HAZARD = "PTL106"       # attr bakes a concrete batch over a -1 feed

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass
class Diagnostic:
    """One finding, with provenance. ``op_idx`` is the index within
    ``block_idx`` (None for block/program-level findings such as
    unused-var)."""
    code: str
    severity: str
    message: str
    block_idx: int = 0
    op_idx: int | None = None
    op_type: str | None = None
    var: str | None = None

    def __str__(self):
        where = f"block {self.block_idx}"
        if self.op_idx is not None:
            where += f" op#{self.op_idx}"
            if self.op_type:
                where += f"({self.op_type})"
        return f"{self.code} {self.severity} {where}: {self.message}"


class ProgramVerifyError(ValueError):
    """A program failed structural verification. ``pass_name`` names the
    transform whose output was rejected (the verify_passes contract);
    ``diagnostics`` carries every finding, errors first."""

    def __init__(self, diagnostics, pass_name=None):
        self.diagnostics = list(diagnostics)
        self.pass_name = pass_name
        errors = [d for d in self.diagnostics if d.severity == ERROR]
        head = (f"program verification failed after pass "
                f"{pass_name!r}" if pass_name else
                "program verification failed")
        lines = [f"{head}: {len(errors)} error(s)"]
        lines += [f"  {d}" for d in errors[:8]]
        if len(errors) > 8:
            lines.append(f"  ... and {len(errors) - 8} more")
        super().__init__("\n".join(lines))

    @property
    def codes(self):
        return sorted({d.code for d in self.diagnostics
                       if d.severity == ERROR})
