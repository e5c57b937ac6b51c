"""The reference's OpTest classes of tests/test_matmul_ops.py on the port: each
class's own data and test methods through tests/torch_op_test.py, every
check_output also held against the reference's executor
(torch_cross.port_optests says how)."""

from torch_cross import port_optests

PORTED = port_optests("test_matmul_ops", globals())
