"""The input pipeline's readers (counterpart of paddle_tpu/reader/):
decorators, batching, the worker pool, recordio creators and the
host-to-device double buffer."""

from .decorator import (map_readers, buffered, compose, chain, shuffle,
                        ComposeNotAligned, firstn, xmap_readers, cache,
                        bucket_by_length, bucket_bound_for)
from .minibatch import batch
from .pool import WorkerPool, pool_map, interleave
from .prefetch import DeviceFeedIterator, double_buffer
from . import creator
from .creator import convert_reader_to_recordio_file

__all__ = [
    "map_readers", "buffered", "compose", "chain", "shuffle",
    "ComposeNotAligned", "firstn", "xmap_readers", "cache", "batch",
    "bucket_by_length", "bucket_bound_for",
    "WorkerPool", "pool_map", "interleave",
    "DeviceFeedIterator", "double_buffer", "creator",
    "convert_reader_to_recordio_file",
]
