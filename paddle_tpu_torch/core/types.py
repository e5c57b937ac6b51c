"""Variable/data types for the IR (counterpart of paddle_tpu/core/types.py).

Dtypes are canonical strings in the IR (what ``Program.to_dict`` writes), so a
program serialized by either package reads the same in the other. At run time
each string maps to a ``torch.dtype``; numpy dtypes are only needed at the
host boundary (feeds, fetches, ``.npy`` files).
"""

import enum

import numpy as np
import torch


class VarType(enum.Enum):
    """Kinds of variables a block may hold (same values as the reference)."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    FEED_MINIBATCH = "feed_minibatch"
    FETCH_LIST = "fetch_list"
    STEP_SCOPES = "step_scopes"
    LOD_RANK_TABLE = "lod_rank_table"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    READER = "reader"
    RAW = "raw"


_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def convert_dtype(dtype):
    """Normalize a dtype spec (str / np.dtype / torch.dtype) to its canonical
    string."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        if dtype not in _TORCH_DTYPES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        return dtype
    if isinstance(dtype, torch.dtype):
        for name, td in _TORCH_DTYPES.items():
            if td == dtype:
                return name
        raise ValueError(f"unsupported dtype {dtype!r}")
    d = np.dtype(dtype)
    if d.name in _TORCH_DTYPES:
        return d.name
    raise ValueError(f"unsupported dtype {dtype!r}")


def torch_dtype(dtype):
    """Canonical string or spec -> torch.dtype."""
    return _TORCH_DTYPES[convert_dtype(dtype)]
