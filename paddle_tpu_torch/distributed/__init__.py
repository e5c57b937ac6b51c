"""Host-side distributed services (counterpart of paddle_tpu/distributed/):
so far the transport alone — the framed RPC codec, ``RpcServer`` /
``RpcClient`` with retries and streaming responses (rpc.py) — and the
deterministic fault injection its tests and the model server take
(fault.py). The parameter server, the elastic master and the process
supervisors are not ported yet."""

from .rpc import (RpcServer, RpcClient, RemoteError, RetryPolicy,
                  SparseGrad, WireStats, send_msg, recv_msg)
from .fault import FaultPlan

__all__ = ["RpcServer", "RpcClient", "RemoteError", "RetryPolicy",
           "SparseGrad", "WireStats", "send_msg", "recv_msg", "FaultPlan"]
