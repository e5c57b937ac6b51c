"""Joining a process group across hosts, and the mesh over all of its
ranks (counterpart of paddle_tpu/parallel/multihost.py).

Every rank runs the same program. ``init_multihost`` joins this process
into the default ``torch.distributed`` group from explicit arguments or,
where they are None, from the ``env://`` variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) that torchrun and
``launch.RankPool`` set. ``global_mesh`` lays the axes out so that the
first axis spans hosts and the others stay within one: data parallelism
tolerates the slower link between hosts, tensor and sequence parallelism
should not cross it. A rank's host is given by ``LOCAL_WORLD_SIZE``
consecutive ranks (the torchrun layout).
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np

from .sharding import Mesh, make_mesh


# how long a collective may wait on a peer before the group raises
_TIMEOUT = timedelta(seconds=300)


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, local_device_ids=None, backend=None):
    """Join the default process group: ``coordinator_address`` "host:port"
    (else ``env://``), ``num_processes`` ranks, this one ``process_id``.
    ``backend`` defaults to NCCL where a card is visible, else gloo; rank
    r of a host uses its card ``local_device_ids[0]`` (default: its local
    rank). Returns the reference's summary dict."""
    import torch
    import torch.distributed as dist

    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    init = f"tcp://{coordinator_address}" if coordinator_address \
        else "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    local = int(os.environ.get("LOCAL_RANK", process_id))
    if backend == "nccl":
        torch.cuda.set_device(local_device_ids[0] if local_device_ids
                              else local)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init,
                                world_size=num_processes, rank=process_id,
                                timeout=_TIMEOUT)
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": torch.cuda.device_count() if backend == "nccl"
        else 1,
        "global_devices": dist.get_world_size(),
        "hosts": max(1, dist.get_world_size() // per_host),
    }


def global_mesh(axes=("dp", "tp"), dcn_axis="dp"):
    """A Mesh over every rank: ``dcn_axis``, the first axis, spans hosts,
    the second axis the ranks within a host. With one host, or one axis,
    it is ``make_mesh`` over all ranks."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world == per_host or len(axes) == 1:
        return make_mesh(world, axes=axes)
    if dcn_axis != axes[0]:
        raise ValueError("dcn_axis must be the first (slowest-varying) "
                         "mesh axis so cross-host traffic stays on the "
                         "data-parallel dimension")
    if len(axes) != 2:
        raise ValueError("provide a custom mesh for >2 axes across hosts")
    if world % per_host:
        raise ValueError("uneven rank counts across hosts; build a custom "
                         "Mesh")
    return Mesh(np.arange(world).reshape(world // per_host, per_host),
                (dcn_axis, axes[1]))
