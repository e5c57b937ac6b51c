"""tests/test_program_verify.py's OpTest case on the port: its one OpTest
subclass is local to test_optest_harness_rejects_wrong_slots, so the port's
counterpart declares the same class over tests/torch_op_test.py; the port's
harness, as the reference's, sends every one-op program through the
structural verifier first (torch_cross.port_optests finds no module-level
class to mix here)."""

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
import torch_op_test
from torch_cross import port_optests

PORTED = port_optests("test_program_verify", globals())


def test_optest_harness_rejects_wrong_slots():
    class BadSlotTest(torch_op_test.OpTest):
        op_type = "relu"
        inputs = {"Input": np.random.rand(2, 2).astype("float32")}
        outputs = {"Out": np.zeros((2, 2), "float32")}

    assert PORTED == []
    with pytest.raises(fluid.ProgramVerifyError):
        BadSlotTest().check_output()
