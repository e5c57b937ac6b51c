"""The data layer (counterpart of paddle_tpu/fluid/layers/io.py:13)."""

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
