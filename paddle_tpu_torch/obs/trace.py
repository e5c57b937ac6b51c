"""Distributed trace-id propagation (counterpart of
paddle_tpu/obs/trace.py): a trace id is made at a client edge (every
``rpc.RpcClient`` call), carried in the RPC request header and restored
server-side, so host spans on both sides of the wire carry the same id.
The primitives live in ``core.profiler``; this module is their public
face.
"""

from __future__ import annotations

from ..core.profiler import (current_trace_id, new_trace_id,
                             reset_trace_id, set_trace_id, trace_context)

__all__ = ["current_trace_id", "new_trace_id", "reset_trace_id",
           "set_trace_id", "trace_context"]
