"""The data layer (counterpart of paddle_tpu/fluid/layers/io.py:13) and
``get_places`` (reference fluid/layers/__init__.py:53)."""

from __future__ import annotations

from ..framework import default_main_program
from ...core.types import VarType


def data(name, shape, dtype="float32", lod_level=0, type=VarType.LOD_TENSOR,
         append_batch_size=True, stop_gradient=True):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, stop_gradient=stop_gradient,
                            type=type, is_data=True)


def get_places(device_count=0, device_type="AUTO"):
    """A var holding the list of this process's devices (the
    ``get_places`` op): ``device_type`` "AUTO", "CPU" or "CUDA",
    ``device_count`` 0 for all of them."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper("get_places")
    out = helper.create_global_variable(shape=(1,), dtype="int64",
                                        persistable=False)
    helper.append_op("get_places", outputs={"Out": [out.name]},
                     attrs={"device_count": device_count,
                            "device_type": device_type})
    return out
