"""Reader creators (counterpart of paddle_tpu/reader/creator.py; Paddle's
python/paddle/v2/reader/creator.py): np_array, text_file, recordio — plus
the fluid-side convert_reader_to_recordio_file (Paddle's
python/paddle/fluid/recordio_writer.py) so any sample reader round-trips
through recordio files.

Samples serialize as pickled tuples of numpy arrays/scalars through the
recordio record codec (``recordio.dumps`` / ``recordio.loads``), so the
files are the JAX package's: either package reads the other's.
"""

from __future__ import annotations

from ..recordio import dumps as _dumps, loads as _loads

__all__ = ["np_array", "text_file", "recordio", "recordio_sharded",
           "convert_reader_to_recordio_file"]


def np_array(x):
    """Reader yielding rows of a numpy array (reference creator.np_array)."""
    import numpy as np

    arr = np.asarray(x)

    def reader():
        for row in arr:
            yield row

    return reader


def text_file(path):
    """Reader yielding stripped lines (reference creator.text_file)."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, decoder=_loads):
    """Reader over one or more recordio files (Paddle's creator.recordio /
    recordio(paths) with the cloud variant elided). ``decoder`` maps raw
    record bytes to a sample."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        from ..recordio import Scanner
        for p in paths:
            for rec in Scanner(p):
                yield decoder(rec)

    return reader


def recordio_sharded(paths, thread_num, decoder=_loads, pool=None,
                     ordered=True):
    """Reader over many recordio files with the decode parallelized: one
    raw-bytes scanner per file, interleaved round-robin, record bytes
    decoded across a ``thread_num``-wide WorkerPool — the runtime form of
    ``fluid.layers.open_files(thread_num=N)``. Every record of every shard
    is delivered exactly once; ``ordered=True`` keeps the deterministic
    interleaved order, ``ordered=False`` yields in decode-completion order.
    ``thread_num<=1`` degrades to the serial :func:`recordio` path (no
    threads spawned)."""
    if isinstance(paths, str):
        paths = paths.split(",")
    if int(thread_num) <= 1 and pool is None:
        return recordio(paths, decoder=decoder)

    from .pool import interleave, pool_map

    def raw_shard(path):
        def reader():
            from ..recordio import Scanner
            for rec in Scanner(path):
                yield rec

        return reader

    # max_open=thread_num: concurrent open shards track the decode width
    # (the reference prefetch pool reads thread_num files at once), so a
    # thousand-file open_files never holds a thousand descriptors
    width = pool.thread_num if pool is not None else int(thread_num)
    raw = interleave([raw_shard(p) for p in paths], max_open=max(2, width))
    return pool_map(decoder, raw, thread_num, ordered=ordered, pool=pool)


def convert_reader_to_recordio_file(path, reader, compressor="deflate",
                                    max_records=1000,
                                    encoder=_dumps):
    """Serialize every sample of ``reader`` into one recordio file; returns
    the record count (Paddle's recordio_writer.py
    convert_reader_to_recordio_file)."""
    from ..recordio import Writer

    n = 0
    with Writer(path, compressor=compressor, max_records=max_records) as w:
        for sample in reader():
            w.write(encoder(sample))
            n += 1
    return n
