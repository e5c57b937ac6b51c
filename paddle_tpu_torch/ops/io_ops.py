"""Device listing and the reader graph (counterpart of
paddle_tpu/ops/io_ops.py:75, :178-290): ``get_places``, the op behind
``fluid.layers.get_places``; the reader creation and decoration ops that a
startup program runs (``create_recordio_file_reader``,
``create_shuffle_reader``, ``create_double_buffer_reader``,
``create_multi_pass_reader``) and ``read``, which pops a batch from the
reader in the scope."""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..core.lod import LoDArray
from ..core.registry import register_op
from ..core.types import torch_dtype


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


# ---------------------------------------------------------------------------
# reader creation/decoration ops (reference :178-290; Paddle's
# operators/reader/): the startup program builds the reader chain into a
# persistable READER var whose runtime value is a reader-creator CALLABLE
# from paddle_tpu_torch.reader; the read op promotes it to a live iterator
# at the first pop
# ---------------------------------------------------------------------------

# promoted-iterator cache for reader creators without a settable __dict__
# (see the read op)
_PROMOTED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@register_op("create_recordio_file_reader")
def create_recordio_file_reader(ctx):
    """create_recordio_file_reader_op.cc / open_files: a creator over one or
    more recordio files; dict records (fluid.recordio_writer batches) become
    slot tuples in insertion (feed) order, tuple records pass through.

    ``thread_num > 1`` (the open_files form) shards the file list into one
    raw-bytes reader per file, interleaved, with record decode running on a
    thread_num-wide WorkerPool (reader/pool.py). The pool lives for one
    pass: created at iterator start, shut down when the pass ends or the
    iterator is abandoned."""
    from ..reader import creator as reader_creator

    paths = list(ctx.attr("filenames"))
    thread_num = int(ctx.attr("thread_num", 1) or 1)

    def _as_tuple(rec):
        if isinstance(rec, dict):
            return tuple(rec.values())
        return rec

    def make():
        base = reader_creator.recordio_sharded(paths, thread_num)
        return (_as_tuple(r) for r in base())

    ctx.set_output("Out", make)


@register_op("create_shuffle_reader")
def create_shuffle_reader_op(ctx):
    from ..reader.decorator import shuffle
    ctx.set_output("Out", shuffle(ctx.input("UnderlyingReader"),
                                  int(ctx.attr("buffer_size", 1024))))


@register_op("create_double_buffer_reader")
def create_double_buffer_reader_op(ctx):
    """create_double_buffer_reader_op.cc: a background thread keeps the
    next ``capacity`` batches staged on the device while the consumer
    computes (reader/prefetch.py's stager: pinned host tensors, a copy
    stream of its own, the consumer's stream made to wait on the copy at
    the pop). The layer's ``place`` attr picks the staging device; without
    it, the executor's."""
    from ..reader.prefetch import device_buffer

    place = str(ctx.attr("place", "") or "") or ctx.device
    ctx.set_output("Out", device_buffer(ctx.input("UnderlyingReader"),
                                        place,
                                        int(ctx.attr("capacity", 2) or 2)))


@register_op("create_multi_pass_reader")
def create_multi_pass_reader_op(ctx):
    underlying = ctx.input("UnderlyingReader")
    pass_num = int(ctx.attr("pass_num", 1))

    def make():
        for _ in range(pass_num):
            yield from underlying()

    ctx.set_output("Out", make)


def _on_device(ctx, value, name):
    """One popped slot as the read op's output: a tensor (or LoDArray) on
    the executor's device in the output var's declared dtype."""
    var = ctx.block.var(name) if ctx.block.has_var(name) else None
    dtype = torch_dtype(var.dtype) if var is not None and var.dtype \
        else None

    def leaf(v, dt):
        t = v if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        return t.to(ctx.device, dt) if dt is not None else t.to(ctx.device)

    if isinstance(value, LoDArray):
        return LoDArray(leaf(value.data, dtype),
                        leaf(value.lens, torch.int32),
                        tuple(leaf(o, torch.int32)
                              for o in value.outer_levels) or None)
    return leaf(value, dtype)


@register_op("read")
def read(ctx):
    """read_op.cc: pop the next batch from a READER variable (a reader
    creator, or a live iterator, in the scope) into the output vars;
    raises StopIteration at end-of-data like the reference (the pass
    ends; the executor writes nothing back for that step)."""
    reader = ctx.input("Reader")
    if callable(reader) and not hasattr(reader, "__next__"):
        # a reader creator: promote to a live iterator ONCE and cache it ON
        # the creator object — the creator is what persists in the scope
        # (the read op only READS the reader var, so env rebinds don't
        # survive the write-back), Paddle's ReaderHolder-in-scope contract
        # (framework/reader.h:68). Creators without __dict__ (e.g.
        # functools.partial) cache via weakref.
        it = getattr(reader, "__promoted_iter__", None) \
            or _PROMOTED.get(reader)
        if it is None:
            it = iter(reader())
            try:
                reader.__promoted_iter__ = it
            except AttributeError:
                _PROMOTED[reader] = it   # TypeError here = unweakrefable
                # creator: a loud error beats silently re-reading batch 0
        creator, reader = reader, it
    else:
        creator = None
    try:
        batch = next(reader)
    except StopIteration:
        # end of pass: clear the cached iterator so the next run starts a
        # fresh pass (the reference's reader reset semantics)
        if creator is not None:
            if hasattr(creator, "__dict__"):
                creator.__dict__.pop("__promoted_iter__", None)
            _PROMOTED.pop(creator, None)
        raise
    outs = ctx.op.output("Out")
    if len(outs) == 1 and not isinstance(batch, (tuple, list)):
        batch = (batch,)
    ctx.set_outputs("Out", [_on_device(ctx, b, n)
                            for b, n in zip(batch, outs)])
