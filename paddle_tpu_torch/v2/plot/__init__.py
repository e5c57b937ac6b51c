"""v2 plot package (reference python/paddle/v2/plot/__init__.py)."""

from .plot import Ploter, PlotData

__all__ = ["Ploter", "PlotData"]
