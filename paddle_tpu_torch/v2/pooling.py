"""v2 pooling objects (reference python/paddle/v2/pooling.py)."""

from .config_helpers import (MaxPooling as Max, AvgPooling as Avg,
                             SumPooling as Sum)

__all__ = ["Max", "Avg", "Sum"]
