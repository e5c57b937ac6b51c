"""``batch`` — group samples into mini-batch lists (counterpart of
paddle_tpu/reader/minibatch.py).

Paddle's python/paddle/v2/minibatch.py:18 contract: the batched reader
yields lists of samples; the trailing partial batch is emitted (drop it
with ``drop_last=True``, which a step of one padded shape wants).
"""

from __future__ import annotations


def batch(reader, batch_size, drop_last=False, pool=None):
    """With ``pool`` (a reader.pool.WorkerPool) batch assembly runs on a
    pool-bookkept staging thread, so the consumer pops ready batches off a
    bounded queue while the next ones assemble."""

    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    if pool is not None:
        return pool.background(batch_reader, capacity=2)
    return batch_reader
