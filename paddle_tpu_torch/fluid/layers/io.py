"""The data layer (counterpart of paddle_tpu/fluid/layers/io.py:13),
``get_places`` (reference fluid/layers/__init__.py:53) and the program-level
reader graph (reference :32-104; Paddle's layers/io.py:261-364)."""

from __future__ import annotations

from ..framework import default_main_program, default_startup_program
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


def get_places(device_count=0, device_type="AUTO"):
    """A var holding the list of this process's devices (the
    ``get_places`` op): ``device_type`` "AUTO", "CPU" or "CUDA",
    ``device_count`` 0 for all of them."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper("get_places")
    out = helper.create_global_variable(shape=(1,), dtype="int64",
                                        persistable=False)
    helper.append_op("get_places", outputs={"Out": [out.name]},
                     attrs={"device_count": device_count,
                            "device_type": device_type})
    return out


# ---------------------------------------------------------------------------
# Program-level reader graph: reader creation/decoration are STARTUP ops
# producing a persistable READER var (a host-side reader-creator callable in
# the scope); the main program's read op pulls batches from it. The runtime
# values live in paddle_tpu_torch.reader (creators, decorators, prefetch);
# these layers wire them into programs.
# ---------------------------------------------------------------------------

def _reader_var(op_type, inputs, attrs, shapes, dtypes, lod_levels):
    from ..framework import unique_name

    name = unique_name(op_type)
    sb = default_startup_program().global_block()
    sv = sb.create_var(name=name, persistable=True)
    sb.append_op(op_type, inputs=inputs, outputs={"Out": [name]},
                 attrs=attrs)
    mv = default_main_program().global_block().create_var(
        name=name, persistable=True)
    for v in (sv, mv):
        v.reader_shapes = list(shapes)
        v.reader_dtypes = list(dtypes)
        v.reader_lod_levels = list(lod_levels)
    return mv


def open_recordio_file(filename, shapes, lod_levels, dtypes):
    """A READER var over one recordio file (Paddle's layers/io.py:261)."""
    return _reader_var("create_recordio_file_reader", {},
                       {"filenames": [filename]}, shapes, dtypes,
                       lod_levels)


def open_files(filenames, thread_num, shapes, lod_levels, dtypes):
    """One READER over many files (Paddle's layers/io.py:290).
    ``thread_num`` is the decode-pool width: at runtime the reader op
    shards the file list into one raw reader per file, interleaved, and
    decodes records across a thread_num-wide WorkerPool
    (reader/pool.py)."""
    return _reader_var("create_recordio_file_reader", {},
                       {"filenames": list(filenames),
                        "thread_num": int(thread_num)},
                       shapes, dtypes, lod_levels)


def _decorated(op_type, reader, attrs):
    return _reader_var(op_type, {"UnderlyingReader": [reader.name]}, attrs,
                       reader.reader_shapes, reader.reader_dtypes,
                       reader.reader_lod_levels)


def create_shuffle_reader(reader, buffer_size):
    return _decorated("create_shuffle_reader", reader,
                      {"buffer_size": int(buffer_size)})


def create_double_buffer_reader(reader, place=None):
    """Batches staged on ``place``'s device (the executor's where None) by
    a background thread, two ahead of the consumer."""
    return _decorated("create_double_buffer_reader", reader,
                      {} if place is None else {"place": str(place)})


def create_multi_pass_reader(reader, pass_num):
    return _decorated("create_multi_pass_reader", reader,
                      {"pass_num": int(pass_num)})


def read_file(file_obj):
    """Pop one batch from a READER var into typed vars (Paddle's
    layers/io.py:352); one var per slot, or the var alone."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper("read_file")
    outs = []
    for shape, dtype, lod in zip(file_obj.reader_shapes,
                                 file_obj.reader_dtypes,
                                 file_obj.reader_lod_levels):
        outs.append(helper.create_tmp_variable(
            dtype, shape=tuple(shape), lod_level=lod, stop_gradient=True))
    helper.append_op("read", inputs={"Reader": [file_obj.name]},
                     outputs={"Out": [o.name for o in outs]})
    return outs[0] if len(outs) == 1 else outs
