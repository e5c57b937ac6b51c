"""The @provider data-provider protocol (counterpart of
paddle_tpu/trainer/PyDataProvider2.py).

Reference: python/paddle/trainer/PyDataProvider2.py:365 (``provider``
decorator) — a user function ``process(settings, filename)`` yielding one
sample at a time becomes a DataProvider the trainer pulls batches through,
with shuffle pooling, per-pass caching, dict-sample reordering by the data
layers' declaration order, and an ``init_hook`` for loading dictionaries.

Integration: a DataProvider instance is itself a reader — pass
``DataProvider(file_list)`` (or its bound class from a config module) where
any reader callable is accepted (``paddle.batch``, ``v2.SGD.train``,
the trainer CLI's ``--reader``). The reference pumped samples through an
embedded CPython inside the C++ trainer; here the reader pipeline is
already host-Python, so the decorator only has to reproduce the protocol.
"""

from __future__ import annotations

import random

from ..v2.data_type import (  # noqa: F401  (reference re-exports the types)
    InputType, dense_vector, dense_vector_sequence, integer_value,
    integer_value_sequence, sparse_binary_vector)

__all__ = ["provider", "CacheType", "InputType", "dense_vector",
           "dense_vector_sequence", "integer_value",
           "integer_value_sequence", "sparse_binary_vector"]


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


_TRUE = {1, True, "t", "true", "on", "1"}
_FALSE = {0, False, "f", "false", "off", "0"}


def _coerce_shuffle(value, is_train):
    if value is None:
        return bool(is_train)   # reference: shuffle iff training
    if isinstance(value, str):
        lowered = value.lower()
        if lowered in _TRUE:
            return True
        if lowered in _FALSE:
            return False
        # a typo like 'ture' must not silently become the is_train default
        known = sorted(s for s in (_TRUE | _FALSE) if isinstance(s, str))
        raise ValueError(
            f"unrecognized should_shuffle string {value!r} (want one of "
            f"{known})")
    if value in _TRUE:
        return True
    if value in _FALSE:
        return False
    return bool(is_train)


def _check_sample(items, input_types):
    import numpy as np
    assert len(items) == len(input_types), \
        f"sample has {len(items)} slots, input_types declares " \
        f"{len(input_types)}"
    for item, tp in zip(items, input_types):
        if tp.seq_type == 0 and tp.dtype == "int64":
            idx = np.asarray(item).reshape(-1)
            assert ((0 <= idx) & (idx < max(tp.dim, 1))).all(), \
                f"integer_value {idx} out of range [0, {tp.dim})"
        elif tp.seq_type == 0:
            arr = np.asarray(item, dtype="float32").reshape(-1)
            assert arr.shape[0] == tp.dim, \
                f"dense_vector dim {arr.shape[0]} != {tp.dim}"


def provider(input_types=None, should_shuffle=None, pool_size=-1,
             min_pool_size=-1, can_over_batch_size=True,
             calc_batch_size=None, cache=CacheType.NO_CACHE, check=False,
             check_fail_continue=False, init_hook=None, **outer_kwargs):
    """Decorator: ``@provider(input_types=[...])`` over
    ``process(settings, filename)`` returns a DataProvider class;
    ``DataProvider(file_list, input_order=..., is_train=...)`` is a reader
    callable yielding samples in input_order."""

    def __wrapper__(generator):
        class DataProvider:
            def __init__(self, file_list, input_order=None, is_train=True,
                         **kwargs):
                self.file_list = list(file_list) \
                    if not isinstance(file_list, str) else [file_list]
                self.input_types = None
                self.is_train = bool(is_train)
                self.should_shuffle = _coerce_shuffle(should_shuffle,
                                                      is_train)
                self.pool_size = pool_size
                self.min_pool_size = min_pool_size
                self.can_over_batch_size = can_over_batch_size
                self.calc_batch_size = calc_batch_size
                self.cache = cache
                self.input_order = list(input_order or [])
                self._cached_pass = None
                # user state (dictionaries etc.) lands on self via init_hook
                if init_hook is not None:
                    init_hook(self, file_list=self.file_list,
                              is_train=is_train, **kwargs)
                if self.input_types is None:
                    self.input_types = input_types
                assert self.input_types is not None, \
                    "Data Provider's input_types must be set"
                self.slots = self.input_types
                if isinstance(self.slots, dict):
                    assert self.input_order, \
                        "dict input_types needs input_order (the data " \
                        "layers' declaration order)"
                    self.slots = [self.input_types[n]
                                  for n in self.input_order]

            # ---- reader protocol ----
            def __call__(self):
                if self.cache == CacheType.CACHE_PASS_IN_MEM and \
                        self._cached_pass is not None:
                    samples = self._cached_pass
                    if self.should_shuffle:
                        samples = list(samples)
                        random.shuffle(samples)
                    yield from samples
                    return
                remember = [] \
                    if self.cache == CacheType.CACHE_PASS_IN_MEM else None
                for sample in self._pooled(self._raw_samples()):
                    if remember is not None:
                        remember.append(sample)
                    yield sample
                if remember is not None:
                    self._cached_pass = remember

            def _raw_samples(self):
                files = list(self.file_list)
                if self.should_shuffle:
                    random.shuffle(files)
                for fname in files:
                    for sample in generator(self, fname):
                        yield from self._normalized(sample)

            def _normalized(self, sample):
                if isinstance(sample, dict):
                    sample = tuple(sample[n] for n in self.input_order)
                elif len(self.slots) == 1 and \
                        not isinstance(sample, (tuple, list)):
                    sample = (sample,)   # SingleSlotWrapper
                else:
                    sample = tuple(sample)
                if check:
                    try:
                        _check_sample(sample, self.slots)
                    except AssertionError:
                        if check_fail_continue:
                            return   # drop the malformed sample
                        raise
                yield sample

            def _pooled(self, it):
                """Shuffle through a bounded sample pool (reference pool_size
                / min_pool_size randomization window)."""
                if not self.should_shuffle:
                    yield from it
                    return
                size = self.pool_size if self.pool_size > 0 else 4096
                pool = []
                for sample in it:
                    pool.append(sample)
                    if len(pool) >= size:
                        random.shuffle(pool)
                        yield from pool
                        pool = []
                random.shuffle(pool)
                yield from pool

        DataProvider.__name__ = getattr(generator, "__name__",
                                        "DataProvider")
        DataProvider.origin = generator
        return DataProvider

    return __wrapper__
