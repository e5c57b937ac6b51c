"""v2 attribute objects (reference python/paddle/v2/attr.py)."""

from .config_helpers import (ParameterAttribute as Param,
                             ExtraLayerAttribute as Extra)

ParamAttr = Param
ExtraAttr = Extra

__all__ = ["Param", "Extra", "ParamAttr", "ExtraAttr"]
