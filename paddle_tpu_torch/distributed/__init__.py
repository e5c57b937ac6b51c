"""Host-side distributed services (counterpart of paddle_tpu/distributed/):
the parameter server (sync/async/bounded-staleness, sharded, leases,
checkpoints; param_server.py), the elastic data-dispatch master
(master.py), the launcher and the process supervisors (launch.py), the
framed RPC transport (rpc.py) and deterministic fault injection
(fault.py).

They are numpy and the standard library only, as the reference's are: a
shard or master process never imports torch, a checkpoint or snapshot is
a plain pickle of numpy state that either package restores, and the wire
is the reference's byte for byte. The trainer side converts at the edge:
``ParamClient`` puts fetched gradients (numpy, or a ``SparseRows`` on the
card) on the wire as numpy, and ``install_params`` copies pulled values
into the scope's tensors on the executor's device.
"""

from .param_server import (ParameterServer, ParamClient, serve, shard_names,
                           OPTIMIZERS, OverlappedRemoteUpdater,
                           install_params)
from .master import Master, MasterClient
from .rpc import (RpcServer, RpcClient, RemoteError, RetryPolicy,
                  SparseGrad, WireStats, send_msg, recv_msg)
from .fault import FaultPlan
from .launch import ChildSupervisor, PserverSupervisor

__all__ = ["ParameterServer", "ParamClient", "serve", "shard_names",
           "OPTIMIZERS", "OverlappedRemoteUpdater", "Master", "MasterClient",
           "RpcServer", "RpcClient", "RemoteError", "RetryPolicy",
           "SparseGrad", "WireStats", "send_msg", "recv_msg", "FaultPlan",
           "ChildSupervisor", "PserverSupervisor", "install_params"]
