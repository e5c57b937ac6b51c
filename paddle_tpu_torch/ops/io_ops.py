"""IO and runtime ops (counterpart of paddle_tpu/ops/io_ops.py): ``fill``,
``delete_var``, ``save``, ``load``, ``save_combine``, ``load_combine`` and
``lod_array_length`` (reference :59-176); ``get_places``, the op behind
``fluid.layers.get_places`` (:75); the reader creation and decoration ops
that a startup program runs (``create_recordio_file_reader``,
``create_shuffle_reader``, ``create_double_buffer_reader``,
``create_multi_pass_reader``) and ``read``, which pops a batch from the
reader in the scope (:178-290); the CSP ops ``channel_create``,
``channel_send``, ``channel_recv``, ``channel_close`` and ``go``
(:299-330), which keep a ``fluid.concurrency.Channel`` in the scope and
run a sub-block on a thread.

The persistence ops keep the reference's file format, so a file either
package writes, the other loads: ``save`` is one ``np.save`` (pickle
allowed) of a host copy, a LoD value as its ``{"data", "lens", "outer"}``
dict of arrays; ``save_combine`` writes one object array holding the
values in order (built element by element, so that same-shaped tensors
stay separate entries) and ``load_combine`` restores them by position.
They are host ops: they run in the eager Executor, like the reference's
save/load programs (python/paddle/fluid/io.py)."""

from __future__ import annotations

import os
import threading
import weakref

import numpy as np
import torch

from ..core.executor import Executor, _run_ops
from ..core.lod import LoDArray
from ..core.registry import register_op
from ..core.types import convert_dtype, torch_dtype


# ---------------------------------------------------------------------------
# fill / delete_var / lod_array_length (reference :59-73, :164-169)
# ---------------------------------------------------------------------------

@register_op("fill")
def fill(ctx):
    """fill_op.cc: the flat "data" attr reshaped to "shape", in "dtype", on
    the executor's device."""
    data = np.asarray(ctx.attr("data"), dtype=np.dtype(convert_dtype(
        ctx.attr("dtype", "float32")))).reshape(tuple(ctx.attr("shape")))
    ctx.set_output("Out", torch.from_numpy(data).to(ctx.device))


@register_op("delete_var")
def delete_var(ctx):
    """delete_var_op.cc: drop the variables from the run's environment;
    the last reference gone, the caching allocator takes the memory back
    (``memory_optimization_transpiler.release_memory`` places these)."""
    for name in ctx.op.input("X"):
        ctx.env.pop(name, None)


@register_op("lod_array_length")
def lod_array_length(ctx):
    """lod_array_length_op.cc: a tensor array's length as int64 [1]."""
    ctx.set_output("Out", ctx.input("X").length.reshape(1).to(torch.int64))


# ---------------------------------------------------------------------------
# save / load (one variable) and save_combine / load_combine (reference
# :85-158)
# ---------------------------------------------------------------------------

def _to_numpy(v):
    """A host copy (bfloat16 as float32), a LoD value as its dict."""
    if not isinstance(v, (torch.Tensor, LoDArray)):
        return np.asarray(v)
    v = Executor._fetch_value(v, True)
    if isinstance(v, LoDArray):
        return {"data": v.data, "lens": v.lens, "outer": list(v.outer_levels)}
    return v


def _from_numpy(v, device):
    def leaf(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))) \
            .to(device)

    if isinstance(v, dict):
        return LoDArray(leaf(v["data"]), leaf(v["lens"]),
                        tuple(leaf(o) for o in v["outer"]) or None)
    return leaf(v)


def _write(op_type, ctx, value):
    """np.save of ``value`` to the op's file_path through a temporary
    file (an atomic rename), refusing to overwrite where overwrite is
    False (save_op.cc's check)."""
    path = ctx.attr("file_path")
    if not ctx.attr("overwrite", True) and os.path.exists(path):
        raise FileExistsError(f"{op_type}: {path} exists and "
                              "overwrite=False (save_op.cc overwrite check)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, value, allow_pickle=True)
    os.replace(tmp, path)


def _read(ctx):
    with open(ctx.attr("file_path"), "rb") as f:
        return np.load(f, allow_pickle=True)


@register_op("save")
def save(ctx):
    _write("save", ctx, _to_numpy(ctx.input("X")))


@register_op("load")
def load(ctx):
    v = _read(ctx)
    if v.dtype == object:
        v = v.item()
    ctx.set_output("Out", _from_numpy(v, ctx.device))


@register_op("save_combine")
def save_combine(ctx):
    vs = ctx.inputs("X")
    container = np.empty(len(vs), dtype=object)
    container[:] = [_to_numpy(v) for v in vs]
    _write("save_combine", ctx, container)


@register_op("load_combine")
def load_combine(ctx):
    ctx.set_outputs("Out", [_from_numpy(v, ctx.device) for v in _read(ctx)])


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


# ---------------------------------------------------------------------------
# CSP channel ops and go (host concurrency through the scope, :299-330)
# ---------------------------------------------------------------------------

@register_op("channel_create")
def channel_create(ctx):
    from ..fluid.concurrency import Channel
    ctx.set_output("Out", Channel(dtype=ctx.attr("data_type", "float32"),
                                  capacity=int(ctx.attr("capacity", 0))))


@register_op("channel_send")
def channel_send(ctx):
    ctx.input("Channel").send(ctx.input("X"))


@register_op("channel_recv")
def channel_recv(ctx):
    v, ok = ctx.input("Channel").recv()
    ctx.set_output("Out", v)
    ctx.set_output("Status", torch.tensor(ok))


@register_op("channel_close")
def channel_close(ctx):
    ctx.input("Channel").close()


@register_op("go", is_control_flow=True)
def go(ctx):
    """go_op.cc: the sub-block runs on a daemon thread over a copy of the
    environment's bindings; a channel in it is the shared object both
    sides talk through. Out is the thread."""
    t = threading.Thread(target=_run_ops,
                         args=(ctx.sub_block(), dict(ctx.env), ctx.device),
                         daemon=True)
    t.start()
    ctx.set_output("Out", t)
