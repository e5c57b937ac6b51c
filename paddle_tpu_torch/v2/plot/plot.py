"""Training-curve plotting for notebooks.

Reference: python/paddle/v2/plot/plot.py — Ploter holds named (step, value)
series appended from the trainer's event handler and renders them with
matplotlib (inline in IPython, or to a file). ``DISABLE_PLOT=True``
disables rendering (the reference's escape hatch for converted-notebook
test runs) while appends keep accumulating, so handlers need no guards.
"""

from __future__ import annotations

import os


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(float(value))

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    """Ploter("train cost", "test cost"): one line per title.

        ploter = Ploter("train cost")
        def handler(evt):
            if isinstance(evt, paddle.event.EndIteration):
                ploter.append("train cost", evt.batch_id, evt.cost)
                ploter.plot()
    """

    def __init__(self, *args):
        self.__args__ = args
        self.__plot_data__ = {title: PlotData() for title in args}
        self.__disable_plot__ = os.environ.get("DISABLE_PLOT")
        if not self.__plot_is_disabled__():
            import matplotlib
            if os.environ.get("DISPLAY") is None:
                matplotlib.use("Agg")   # headless render-to-file
            import matplotlib.pyplot as plt
            self.plt = plt
            try:
                from IPython import display
                self.display = display
            except ImportError:
                self.display = None

    def __plot_is_disabled__(self):
        return self.__disable_plot__ == "True"

    def append(self, title, step, value):
        assert title in self.__plot_data__, (
            f"unknown series {title!r}; declared: {list(self.__plot_data__)}")
        self.__plot_data__[title].append(step, value)

    def plot(self, path=None):
        if self.__plot_is_disabled__():
            return
        # draw the non-empty series in declaration order
        drawn = [t for t in self.__args__ if self.__plot_data__[t].step]
        for t in drawn:
            series = self.__plot_data__[t]
            self.plt.plot(series.step, series.value)
        self.plt.legend(drawn, loc="upper left")
        if path is not None:
            self.plt.savefig(path)
        elif self.display is not None:
            self.display.clear_output(wait=True)
            self.display.display(self.plt.gcf())
        self.plt.gcf().clear()

    def reset(self):
        for data in self.__plot_data__.values():
            data.reset()


__all__ = ["Ploter", "PlotData"]
