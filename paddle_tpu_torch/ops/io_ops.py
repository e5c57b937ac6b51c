"""Device listing (counterpart of paddle_tpu/ops/io_ops.py:75):
``get_places``, the op behind ``fluid.layers.get_places``."""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("get_places")
def get_places(ctx):
    """The devices of this process as a list of ``torch.device``
    (get_places_op.cc): ``device_type`` "CPU" gives the CPU, "CUDA" every
    card (and raises where there is none), "AUTO" the cards when the
    executor runs on one, else the CPU; ``device_count`` 0 means all of
    them, N the first N."""
    kind = str(ctx.attr("device_type", "AUTO")).upper()
    count = int(ctx.attr("device_count", 0) or 0)
    if kind == "CPU" or (kind == "AUTO" and ctx.device.type != "cuda"):
        devs = [torch.device("cpu")]
    elif kind in ("CUDA", "AUTO"):
        n = torch.cuda.device_count()
        if not n:
            raise RuntimeError("get_places: device_type CUDA, and no CUDA "
                               "device is available")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"get_places: unknown device_type {kind!r}")
    ctx.set_output("Out", devs[:count] if count else devs)
