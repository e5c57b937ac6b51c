"""The user-facing profiler (counterpart of paddle_tpu/fluid/profiler.py;
Paddle's python/paddle/fluid/profiler.py:33-109), over the port's
host-span profiler in ``core/profiler.py``.

``profiler(...)`` is the reference's context manager: enable, run the
loop, print the per-op report and, given ``profile_path``, write
chrome://tracing JSON of the host spans. ``cuda_profiler`` (the
reference's ``device_tracer``, its CUPTI DeviceTracer analog) is a
``torch.profiler`` trace of the enclosed region with CUDA activity where a
card is present, written as chrome-tracing JSON: the device kernels by
name (``conv_affine_kernel``, ...) on their own tracks.
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager

from ..core import profiler as _core


@contextmanager
def profiler(state="All", sorted_key=None, profile_path=None, file=None):
    """Profile the enclosed region; on exit print the per-span report
    (sorted by ``sorted_key`` in {'calls', 'total', 'max', 'min', 'ave'})
    and, where ``profile_path`` is given, write chrome://tracing JSON
    there."""
    _core.enable_profiler(state)
    try:
        yield
    finally:
        rows = _core.disable_profiler(sorted_key, profile_path)
        _core.print_summary(rows, file=file or sys.stdout)


def start_profiler(state="All"):
    _core.enable_profiler(state)


def stop_profiler(sorted_key=None, profile_path=None, file=None):
    rows = _core.disable_profiler(sorted_key, profile_path)
    _core.print_summary(rows, file=file or sys.stdout)
    return rows


def reset_profiler():
    _core.reset_profiler()


@contextmanager
def device_tracer(output_file):
    """A ``torch.profiler`` trace of the enclosed region, CPU activity and,
    where a card is present, CUDA activity (CUPTI), written on exit as
    chrome-tracing JSON to ``output_file`` (a path ending in ``.json``;
    any other path is a log directory that receives ``trace.json``, as
    the reference's ``device_tracer(logdir)`` takes). Yields the
    ``torch.profiler.profile`` object (``key_averages()``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = output_file if str(output_file).endswith(".json") else \
        os.path.join(output_file, "trace.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


# the reference's name for the same trace (Paddle's CUPTI profiler)
cuda_profiler = device_tracer


__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "cuda_profiler", "device_tracer"]
