"""Serving a LoD-input bundle: neither package's InferenceEngine has a
ragged path. A bundle of a one-layer ``dynamic_lstm`` classifier over a
``lod_level=1`` int64 feed, saved by each package: both engines refuse a
metadata ``warmup()`` with ValueError (the feed var is ragged), and both
fail inside the first fc on a padded dense sample feed. The same bundles'
replies through the executor and through ``fluid.aot`` are held by
tests/test_torch_aot.py and the text-classifier tests."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.serving import InferenceEngine as RefEngine
from paddle_tpu_torch.serving import InferenceEngine as PortEngine
from paddle_tpu_torch.testing import models as M


def _save(fluid, exe, d):
    fluid.framework.reset_unique_name()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        prob = M.lstm_textcls(words, vocab=30, emb=8, hidden=16, lstm_num=1,
                              layers=fluid.layers)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(d, ["words"], [prob], exe, main,
                                  scope=scope)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("lod_bundles")
    ref, port = str(root / "ref"), str(root / "port")
    _save(jfluid, jfluid.Executor(jfluid.CPUPlace()), ref)
    _save(tfluid, tfluid.Executor(tfluid.CPUPlace()), port)
    return ref, port


def _engines(bundles):
    for d in bundles:
        yield "reference", RefEngine(d, buckets="1,4")
        yield "port", PortEngine(d, place=tfluid.CPUPlace(), buckets="1,4")


def test_both_engines_refuse_a_metadata_warmup_of_a_lod_feed(bundles):
    for who, eng in _engines(bundles):
        with pytest.raises(ValueError, match="words"):
            eng.warmup()


def test_both_engines_fail_on_a_padded_dense_feed(bundles):
    """A padded [3, 7, 1] int64 feed reaches the first fc as a [3, 7·8]
    embedding; the fc's [8, 64] weight does not take it."""
    feed = {"words": np.zeros((3, 7, 1), "int64")}
    for who, eng in _engines(bundles):
        with pytest.raises(Exception) as info:
            eng.warmup(sample_feed=feed)
        assert not isinstance(info.value, AssertionError), who
        msg = str(info.value)
        assert "56" in msg and "8" in msg, (who, msg)
