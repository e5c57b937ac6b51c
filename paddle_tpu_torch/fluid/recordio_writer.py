"""Convert a reader into RecordIO files (counterpart of
paddle_tpu/fluid/recordio_writer.py; Paddle's python/paddle/fluid/
recordio_writer.py convert_reader_to_recordio_file :30 over the C++
RecordIOWriter). Records are pickled feed dicts (one per batch) through the
recordio record codec, so a file is the one the JAX package writes for the
same batches: a LoD column goes on disk as the JAX package's LoDArray with
numpy leaves."""

from __future__ import annotations

from ..recordio import Writer, dumps

__all__ = ["convert_reader_to_recordio_file"]


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor="deflate",
                                    max_num_records=1000, feed_order=None):
    """Each batch from ``reader_creator`` becomes one record: the feeder's
    feed dict (ordered by ``feed_order``) pickled. Without a feeder, raw
    batches are pickled. Returns the record count."""
    counter = 0
    with Writer(filename, compressor=compressor,
                max_records=max_num_records) as writer:
        for batch in reader_creator():
            if feeder is not None:
                res = feeder.feed(batch)
                order = feed_order or [v.name for v in feeder.feed_vars]
                payload = {name: res[name] for name in order}
            else:
                payload = batch
            writer.write(dumps(payload))
            counter += 1
    return counter
