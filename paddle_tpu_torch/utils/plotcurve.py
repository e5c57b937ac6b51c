"""Plot cost curves from training logs.

Reference: python/paddle/utils/plotcurve.py — greps ``Pass=..., Cost=...``
(and AvgCost) lines out of a paddle_trainer log and plots cost vs pass via
matplotlib, or writes the parsed points when no display exists. The v2
trainer here logs the same shape through its event stream; this parses
either the reference log format or this framework's event lines.
"""

from __future__ import annotations

import re
import sys

__all__ = ["parse_log", "plotcurve"]

# reference trainer log:  "... Pass=3 ... Cost=0.53 ... AvgCost=0.61 ..."
# (AvgCost preferred when present, like the reference's avgcost series);
# v2 event printer here:  "Pass 3, Batch 10, Cost 0.53"
_PATTERNS = (
    re.compile(r"Pass=(\d+).*AvgCost=([0-9.eE+-]+)"),
    re.compile(r"Pass=(\d+).*?Cost=([0-9.eE+-]+)"),
    re.compile(r"Pass (\d+),.*?Cost ([0-9.eE+-]+)"),
)


def parse_log(lines):
    """[(pass_id, cost)] from an iterable of log lines (last cost per pass
    wins, matching the reference's per-pass points)."""
    by_pass = {}
    for line in lines:
        for pat in _PATTERNS:
            m = pat.search(line)
            if m:
                by_pass[int(m.group(1))] = float(m.group(2))
                break
    return sorted(by_pass.items())


def plotcurve(lines, output_file=None):
    """Plot (or, without matplotlib/display, dump) the cost curve; returns
    the parsed [(pass, cost)] points either way."""
    points = parse_log(lines)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        if output_file:
            with open(output_file, "w") as f:
                for p, c in points:
                    f.write(f"{p}\t{c}\n")
        return points
    if points:
        fig, ax = plt.subplots()
        xs, ys = zip(*points)
        ax.plot(xs, ys)
        ax.set_xlabel("pass")
        ax.set_ylabel("cost")
        if output_file:
            fig.savefig(output_file)
        plt.close(fig)
    return points


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    src = open(argv[0]) if argv else sys.stdin
    out = argv[1] if len(argv) > 1 else None
    for p, c in plotcurve(src, out):
        print(f"pass {p}: cost {c}")


if __name__ == "__main__":
    main()
